"""Helpers shared by the 3xTF32 tensor-core kernels (`frontend_cuda`,
`gmm_cuda`): the TF32 hi/lo split, the cache of kernel tables derived
from a source table, and the card's SM count."""

from __future__ import annotations

import functools

import torch
from torch.utils.weak import WeakTensorKeyDictionary


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties away from
    zero), as ``cvt.rna.tf32.f32`` rounds: the 13 low bits cleared."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 -> (hi, lo) TF32 parts: hi = tf32(t), lo = tf32(t - hi)."""
    hi = round_tf32(t)
    return hi, round_tf32(t - hi)


# kernel layout of a source table, held as long as that tensor lives
_DERIVED = WeakTensorKeyDictionary()


def derived(table: torch.Tensor, make, tag=None):
    """``make(table)``, made once per table, version and ``tag`` (what
    else the layout depends on).  It is made on the host and uploaded: in
    a fresh process the first launches of a dozen torch ops on the GPU
    take ~0.2 s, the host work a few ms."""
    key = (table._version, tag)
    hit = _DERIVED.get(table)
    if hit is None or hit[0] != key:
        made = tuple(t.to(table.device) for t in make(table.cpu()))
        hit = _DERIVED[table] = (key, made)
    return hit[1]


@functools.lru_cache(maxsize=None)
def num_sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()
