"""Log-semiring primitives shared by scoring, decoding and training.

Counterpart of `aaltoasr_tpu/ops/logsemiring.py`.  ``LOG_ZERO`` is the
finite stand-in for log(0): small enough that exp() is 0 in float32,
large enough that two additions stay far from float32 overflow, so
(-inf) - (-inf) NaNs never arise.
"""

from __future__ import annotations

import numpy as np
import torch

LOG_ZERO = -1.0e30

# safe_log floor: log(1e-50) (`aku/util.hh:131-139`)
SAFE_LOG_FLOOR = float(np.log(1e-50))


def safe_log(x: torch.Tensor) -> torch.Tensor:
    """Elementwise log with the reference's 1e-50 floor (util.hh:133)."""
    return torch.log(torch.clamp(x, min=1e-50))


def logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Numerically stable pairwise log-add that tolerates LOG_ZERO inputs."""
    mx = torch.maximum(a, b)
    mn = torch.minimum(a, b)
    out = mx + torch.log1p(torch.exp(torch.clamp(mn - mx, min=-80.0)))
    # both LOG_ZERO -> LOG_ZERO (avoid LOG_ZERO + log(2))
    return torch.where(mx <= LOG_ZERO / 2, torch.full_like(out, LOG_ZERO),
                       out)


def logsumexp(x: torch.Tensor, dim: int = -1, keepdim: bool = False,
              where: torch.Tensor | None = None) -> torch.Tensor:
    """Masked logsumexp that returns LOG_ZERO for fully-masked slices."""
    if where is not None:
        x = torch.where(where, x, torch.full_like(x, LOG_ZERO))
    mx = torch.amax(x, dim=dim, keepdim=True)
    safe_mx = torch.clamp(mx, min=LOG_ZERO / 2)
    s = torch.sum(torch.exp(x - safe_mx), dim=dim, keepdim=True)
    out = torch.where(mx <= LOG_ZERO / 2, torch.full_like(mx, LOG_ZERO),
                      safe_mx + torch.log(s))
    if not keepdim:
        out = out.squeeze(dim)
    return out


def segment_logsumexp(x: torch.Tensor, segment_ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """Log-sum-exp of ``x`` [N, ...] grouped along dim 0 by
    ``segment_ids`` [N] -> [num_segments, ...].

    The log-domain analog of scatter-add, used to reduce arc scores onto
    lattice nodes.  Two-pass max-shift for stability; empty segments
    give LOG_ZERO.
    """
    ids = segment_ids.to(torch.int64)
    idx = ids.view((-1,) + (1,) * (x.dim() - 1)).expand_as(x)
    shape = (num_segments,) + tuple(x.shape[1:])
    seg_max = torch.full(shape, float("-inf"), dtype=x.dtype,
                         device=x.device).scatter_reduce(
        0, idx, x, "amax", include_self=True)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                          torch.full_like(seg_max, LOG_ZERO))
    safe = torch.clamp(seg_max, min=LOG_ZERO / 2)
    shifted = torch.exp(x - safe[ids])
    sums = torch.zeros(shape, dtype=x.dtype, device=x.device).index_add_(
        0, ids, shifted)
    return torch.where(seg_max <= LOG_ZERO / 2,
                       torch.full_like(seg_max, LOG_ZERO),
                       safe + torch.log(torch.clamp(sums, min=1e-37)))
