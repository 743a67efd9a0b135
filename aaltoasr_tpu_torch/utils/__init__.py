"""Shared utilities: tracing."""

from aaltoasr_tpu_torch.utils.profiling import device_trace

__all__ = ["device_trace"]
