"""Fused GMM state likelihoods: scoring without the gather, as one kernel.

Counterpart of `aaltoasr_tpu/ops/gmm_pallas.py`.  The host restructures
the tables so that no gather is needed: for each mixture component slot
k the Gaussians' score columns are pre-gathered into a dense slab
``we[k] = score_matrix[:, comp_idx[:, k]]``, with the Gaussian constant
and log mixture weight folded into an extra row that meets a
constant-one input.  `gmm_state_ll` then computes

    e_k  = [x^2, x, 1] @ we[k]        (one product per component slot)
    out  = online logsumexp over k    ([T, Spp] written once)

with the hand-written CUDA kernel `csrc/gmm_state_ll.cu` on CUDA
tensors, and with its plain PyTorch version `reference_state_ll` on CPU
tensors.  Results differ from `GmmScorer.state_log_likelihoods` only by
the order of the logsumexp reduction.

The kernel runs the products on the tensor cores as 3xTF32: the slabs
are split into TF32 hi and lo parts and laid out as the kernel's shared
memory holds them, one contiguous run per k-slice (`slab_layout`,
`slab_table`), on the host, once per slab tensor; the kernel splits each
feature term after its shared-memory load.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from aaltoasr_tpu_torch.ops.cuda_build import (
    SMEM_LIMIT, check, load_library)
from aaltoasr_tpu_torch.ops.gmm import GmmScorer, _round_up, lna_normalize
from aaltoasr_tpu_torch.ops.logsemiring import LOG_ZERO
from aaltoasr_tpu_torch.ops.tf32 import (
    derived, device_index, num_sms, split_tf32)
from aaltoasr_tpu_torch.utils import profiling

SOURCE = "gmm_state_ll.cu"
TILE_S = 512            # state padding of the slabs
_LANE = 128             # feature-row padding of the slabs
DEPTH_STEP = 16         # the kernel's k-slice: slab depth 2D+1 padded to it
# (frames, states) per block of the batch tile and the one-utterance tile,
# and the stages of their slab rings: the source's `Batch` and `Utt`
TILES = ((128, 64), (64, 64))
RING = 3


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare a build's launcher: x, slab table, out, T, D, K, depth,
    Spp, tile, stream."""
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.gmm_state_ll_launch.argtypes = [vp] * 3 + [i] * 6 + [vp]
    lib.gmm_state_ll_launch.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(load_library(SOURCE))


def slab_depth(dim: int) -> int:
    """Depth of the kernel's slab rows: 2*dim+1 padded to DEPTH_STEP."""
    return _round_up(2 * dim + 1, DEPTH_STEP)


def smem_bytes(tile: int, depth: int) -> int:
    """Shared memory of one kernel block (`smem_bytes` in the source):
    the [frames, depth + 4] xq tile, the ring of hi and lo slab slices and
    the running sums (32 a thread, 2 threads a frame), and two barriers
    per ring stage."""
    frames, states = TILES[tile]
    return 4 * (frames * (depth + 4) + RING * 2 * states * DEPTH_STEP
                + frames * 2 * 32) + 16 * RING


def pick_tile(T: int, Spp: int, dim: int, num_sms: int) -> int:
    """Tile index: the batch tile once its blocks fill the card twice over
    and its xq tile fits, else the one-utterance tile, which spreads
    about 1,000 frames over more blocks; raises when neither fits."""
    depth = slab_depth(dim)
    frames, states = TILES[0]
    if (smem_bytes(0, depth) <= SMEM_LIMIT
            and -(-T // frames) * (Spp // states) >= 2 * num_sms):
        return 0
    if smem_bytes(1, depth) <= SMEM_LIMIT:
        return 1
    raise ValueError(f"gmm_state_ll: dim {dim} needs "
                     f"{smem_bytes(1, depth)} bytes of shared memory, above "
                     f"the {SMEM_LIMIT} limit")


def slab_layout(we: torch.Tensor, dim: int) -> torch.Tensor:
    """[K, Dq, Spp] slabs -> [K, Spp, depth]: transposed so a k-slice of a
    state's column is contiguous (the MMA's K-major B operand), the live
    rows 2*dim+1 zero-padded to `slab_depth`."""
    K, _, Spp = we.shape
    d2 = 2 * dim + 1
    out = we.new_zeros((K, Spp, slab_depth(dim)))
    out[:, :, :d2] = we[:, :d2, :].transpose(1, 2)
    return out


def slab_tiles(lay: torch.Tensor) -> torch.Tensor:
    """[K, Spp, depth] -> [K, Spp/64, depth/16, 2, 1024]: per k-slice of a
    64-state tile, its TF32 hi then lo part, each as the 8 x 4 core
    matrices of wgmma's no-swizzle layout (core matrix (n/8, c) holds
    state n's depth-vector c of 4 at row n % 8)."""
    K, Spp, depth = lay.shape
    states = TILES[0][1]
    v = lay.reshape(K, Spp // states, states // 8, 8, depth // DEPTH_STEP,
                    DEPTH_STEP // 4, 4)
    # -> [K, tile, slice, n / 8, c, n % 8, 4]
    v = v.permute(0, 1, 4, 2, 5, 3, 6).reshape(
        K, Spp // states, depth // DEPTH_STEP, 1, states * DEPTH_STEP)
    return torch.cat(split_tf32(v), dim=3)


def slab_table(we: torch.Tensor, dim: int) -> torch.Tensor:
    """`slab_tiles(slab_layout(we))` on the slabs' device, made once per
    slab tensor (on the host)."""
    return derived(we, lambda t: (slab_tiles(slab_layout(t, dim)),),
                   tag=dim)[0]


def reference_state_ll(features: torch.Tensor, we: torch.Tensor,
                       dim: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: [T, D] -> [T, Spp], the K
    slabs folded by the same online logsumexp."""
    K, Dq, Spp = we.shape
    x = features.float()
    one = torch.ones(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    xq = torch.cat([x * x, x, one], dim=-1)
    xq = torch.nn.functional.pad(xq, (0, Dq - xq.shape[-1]))
    m = xq @ we[0]
    s = torch.ones_like(m)
    for k in range(1, K):
        e = xq @ we[k]
        m2 = torch.maximum(m, e)
        # exp arguments are <= 0; LOG_ZERO-padded slots underflow to 0
        s = s * torch.exp(m - m2) + torch.exp(e - m2)
        m = m2
    return torch.where(m <= LOG_ZERO / 2, torch.full_like(m, LOG_ZERO),
                       m + torch.log(s))


def gmm_state_ll(features: torch.Tensor, we: torch.Tensor,
                 dim: int) -> torch.Tensor:
    """[T, D] features, [K, Dq, Spp] slabs -> [T, Spp] state log-likelihoods.

    CUDA tensors launch the kernel, with the tile picked from T
    (`pick_tile`); CPU tensors take `reference_state_ll`.
    """
    if features.device.type == "cpu":
        return reference_state_ll(features, we, dim)
    if features.device.type != "cuda":
        raise ValueError(f"gmm_state_ll: unsupported device {features.device}")
    for name, t in (("features", features), ("we", we)):
        if t.device != features.device:
            raise ValueError(f"gmm_state_ll: {name} is on {t.device}, "
                             f"features on {features.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"gmm_state_ll: {name} must be float32, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"gmm_state_ll: {name} must be contiguous")
    K, Dq, Spp = we.shape
    if features.dim() != 2 or features.shape[1] != dim:
        raise ValueError(f"gmm_state_ll: features must be [T, {dim}], got "
                         f"{tuple(features.shape)}")
    T = features.shape[0]
    tile = pick_tile(T, Spp, dim,
                     num_sms(device_index(features.device)))
    if K < 1 or Dq < 2 * dim + 1 or Spp % TILES[tile][1]:
        raise ValueError(f"gmm_state_ll: bad slab shape {tuple(we.shape)} "
                         f"for dim {dim}")
    lib = _lib()
    out = torch.empty((T, Spp), dtype=torch.float32, device=features.device)
    if T == 0:
        return out
    err = lib.gmm_state_ll_launch(
        features.data_ptr(), slab_table(we, dim).data_ptr(), out.data_ptr(),
        T, dim, K, slab_depth(dim), Spp, tile,
        torch.cuda.current_stream(features.device).cuda_stream)
    check(lib, err, "gmm_state_ll")
    profiling.count("k1.launches")
    return out


@dataclass(frozen=True)
class FusedGmmScorer:
    """Slabs for the fused state-likelihood kernel.

    we  [K, Dq, Spp]  per-component-slot weight slabs; row ``2*dim``
                      carries the folded bias (constant-one input),
                      Dq = 2*dim+1 rounded up to 128.
    """

    dim: int
    num_states: int
    we: torch.Tensor

    @classmethod
    def from_scorer(cls, scorer: GmmScorer) -> "FusedGmmScorer":
        """Build from a diagonal-covariance `GmmScorer`, on its device
        (no full-cov / subspace / cluster-gated models: those keep the
        plain path).  On a GPU the kernel's slab table is made here, once."""
        if scorer.full_cov or scorer.sub_basis or (
                scorer.cluster_of is not None):
            raise ValueError(
                "fused scoring supports plain diagonal GMMs only")
        if smem_bytes(1, slab_depth(scorer.dim)) > SMEM_LIMIT:
            raise ValueError(f"feature dimension {scorer.dim} exceeds the "
                             "fused kernel's shared memory")
        A = scorer.score_matrix.cpu().numpy()        # [2D, Gp]
        b = scorer.score_bias.cpu().numpy()          # [Gp]
        ci = scorer.comp_idx.cpu().numpy()           # [Sp, K]
        cw = scorer.comp_logw.cpu().numpy()          # [Sp, K]
        Sp, K = ci.shape
        D2 = A.shape[0]
        Dq = _round_up(D2 + 1, _LANE)
        Spp = _round_up(max(Sp, scorer.num_states), TILE_S)
        we = np.zeros((K, Dq, Spp), dtype=np.float32)
        for k in range(K):
            we[k, :D2, :Sp] = A[:, ci[:, k]]
            # folded bias: Gaussian constant + log mixture weight
            # (LOG_ZERO-padded slots stay LOG_ZERO: b+cw ~ -1e30)
            we[k, D2, :Sp] = np.maximum(b[ci[:, k]] + cw[:, k], LOG_ZERO)
            we[k, D2, Sp:] = LOG_ZERO
        fused = cls(dim=scorer.dim, num_states=scorer.num_states,
                    we=torch.as_tensor(we, device=scorer.device))
        if fused.we.device.type == "cuda":
            slab_table(fused.we, fused.dim)
        return fused

    def state_log_likelihoods(self, features: torch.Tensor) -> torch.Tensor:
        """[T, D] or [B, T, D] -> [..., T, Spp] tied-state log-likelihoods
        (`GmmScorer.state_log_likelihoods` up to reduction order)."""
        x = features.float()
        flat = x.reshape(-1, x.shape[-1]).contiguous()
        out = gmm_state_ll(flat, self.we, self.dim)
        return out.reshape(x.shape[:-1] + (out.shape[-1],))

    def lna_log_probs(self, features: torch.Tensor) -> torch.Tensor:
        """[..., T, D] -> [..., T, S] LNA-normalized log-probs
        (`aku/PhoneProbsToolbox.cc:93-105` semantics)."""
        with profiling.span("scoring.lna"):
            ll = self.state_log_likelihoods(features)[..., :self.num_states]
            return lna_normalize(ll)
