"""The device the port's entry points run on: the GPU unless the caller
asks for the CPU, and never the CPU in the GPU's place."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device: torch.device | str = "cuda") -> torch.device:
    """``torch.device(device)``; raises when it names CUDA and no CUDA
    device is present, instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device '{dev}' asked for, but no CUDA device is present; "
            "pass device='cpu' (--device cpu) to run on the CPU")
    return dev


@contextlib.contextmanager
def ieee_float32():
    """float32 products inside run in IEEE float32 (no TF32), whatever
    the caller's matmul precision; it is restored on exit."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)
