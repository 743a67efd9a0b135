"""Shared utilities: timing/tracing."""

from aaltoasr_tpu_torch.utils.profiling import StageTimer, device_trace

__all__ = ["StageTimer", "device_trace"]
