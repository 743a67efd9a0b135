"""The masked forward-backward's time recursions as one CUDA kernel launch.

`chain_fb` runs `csrc/chain_fb.cu` on CUDA tensors: the forward
recursion of every utterance of a batch and, unless ``backward`` is
False, its backward recursion, in one launch of 2B blocks (B for the
forward alone).  It computes what the plain loops of
`aaltoasr_tpu_torch/train/estep.py` compute, in the same order: the
gather form (`_gather_loops`) or, with ``shift``, the shift form of a
shift-compiled graph (`_shift_loops`), in float32 with IEEE exp and
log, and writes the same frozen rows past each utterance's
``n_frames``; `estep._recursions` picks between the kernel and the
loops by device.  The kernel replaces no TPU kernel: the JAX package's
recursions are `lax.scan`s, which XLA runs as one device loop.

The kernel keeps two [P] rows and a ring of ``RING`` observation rows in
shared memory, and the gather form's fan tables beside them when they
fit; at a P whose rows do not fit, nothing (`plan`).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F_

from aaltoasr_tpu_torch.ops.cuda_build import SMEM_LIMIT, check, load_library
from aaltoasr_tpu_torch.utils import profiling

SOURCE = "chain_fb.cu"
RING = 8            # observation rows in the kernel's ring, as in the source


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.chain_fb_launch.argtypes = [vp] * 18 + [i] * 7 + [vp]
    lib.chain_fb_launch.restype = i
    lib.chain_fb_ring.restype = i
    if lib.chain_fb_ring() != RING:
        raise RuntimeError(f"chain_fb: the library's ring differs from {RING}")
    return lib


def smem_bytes(P: int, F: int, level: int) -> int:
    """Shared memory of one block at plan ``level`` (`smem_bytes` in the
    source): from 1 two rows and the ring, at 2 also the [F, P] int32
    indices and float32 weights."""
    return (4 * P * (2 + RING) if level >= 1 else 0) + (
        8 * P * F if level == 2 else 0)


def plan(P: int, F: int, shift: bool = False) -> int:
    """What a block of P positions keeps in shared memory: 2 the rows,
    the ring and the gather form's fan tables (fan F), 1 the rows and the
    ring, 0 nothing.  The shift form has no fan tables: at most 1."""
    return next(k for k in ((1, 0) if shift else (2, 1, 0))
                if smem_bytes(P, F, k) <= SMEM_LIMIT)


def supports(obs_pos) -> bool:
    """Whether `chain_fb` takes ``obs_pos``: it lies on a CUDA device."""
    return obs_pos.device.type == "cuda"


def _grouped(end, P: int):
    """Irregular edge ids [B, E] grouped by ``end`` [B, E] (a stable sort:
    edge order within a group) and each group's start [B, P + 1]."""
    order = torch.sort(end, dim=1, stable=True).indices
    counts = torch.zeros((end.shape[0], P), dtype=torch.int64,
                         device=end.device).scatter_add_(
        1, end, torch.ones_like(end))
    start = F_.pad(torch.cumsum(counts, dim=1), (1, 0))
    return order.to(torch.int32), start.to(torch.int32)


def chain_fb(obs_pos, graph, entry, final, n_frames, shift: bool = False,
             backward: bool = True):
    """obs_pos [B, T, P] and a stacked graph (`estep.stack_graphs`: the
    gather form's in_src/in_logp/out_tgt/out_logp [B, P, F] or, with
    ``shift``, sh_logp [B, 3, P] and ir_src/ir_tgt/ir_logp [B, E]), entry
    and final [B, P], n_frames [B] -> (alphas [B, T, P], betas [B, T, P]
    or None)."""
    B, T, P = obs_pos.shape
    dev = obs_pos.device
    if dev.type != "cuda":
        raise ValueError(f"chain_fb: no kernel on {dev}")
    if shift:
        E = graph["ir_src"].shape[1]
        F = 1
        tables = {"sh_logp": (B, 3, P), "ir_src": (B, E), "ir_tgt": (B, E),
                  "ir_logp": (B, E)}
    else:
        E = 0
        F = graph["in_src"].shape[2]
        tables = {k: (B, P, F)
                  for k in ("in_src", "in_logp", "out_tgt", "out_logp")}
    for name, t, shape in ([(k, graph[k], s) for k, s in tables.items()]
                           + [("entry", entry, (B, P)),
                              ("final", final, (B, P)),
                              ("n_frames", n_frames, (B,))]):
        if tuple(t.shape) != shape:
            raise ValueError(f"chain_fb: {name} is {tuple(t.shape)}, "
                             f"not {shape}")

    def on(t, dtype):
        return t.to(dev, dtype).contiguous()
    keep = [on(obs_pos, torch.float32)]
    if shift:
        src = on(graph["ir_src"], torch.int64).clamp(0, P - 1)
        tgt = on(graph["ir_tgt"], torch.int64).clamp(0, P - 1)
        keep += [None] * 4 + [on(graph["sh_logp"], torch.float32),
                              src.to(torch.int32), tgt.to(torch.int32),
                              on(graph["ir_logp"], torch.float32),
                              *_grouped(tgt, P), *_grouped(src, P)]
    else:
        keep += [on(graph[k], dtype) for k, dtype in (
            ("in_src", torch.int64), ("in_logp", torch.float32),
            ("out_tgt", torch.int64), ("out_logp", torch.float32))]
        keep += [None] * 8
    keep += [on(entry, torch.float32), on(final, torch.float32),
             on(n_frames, torch.int64)]
    alphas = torch.empty((B, T, P), dtype=torch.float32, device=dev)
    betas = (torch.empty((B, T, P), dtype=torch.float32, device=dev)
             if backward else None)
    if B == 0 or T == 0:
        return alphas, betas
    lib = _lib()
    err = lib.chain_fb_launch(
        *(None if a is None else a.data_ptr() for a in keep),
        alphas.data_ptr(), betas.data_ptr() if backward else None,
        B, T, P, F, E, int(shift), plan(P, F, shift),
        torch.cuda.current_stream(dev).cuda_stream)
    check(lib, err, "chain_fb")
    profiling.count("fb.launches")
    profiling.count("fb.frames", B * T)
    return alphas, betas
