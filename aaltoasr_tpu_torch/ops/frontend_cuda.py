"""Fused MFCC core: frames -> DFT -> mel -> DCT (+ power), as one kernel.

Counterpart of `aaltoasr_tpu/ops/frontend_pallas.py`.  `mfcc_core` runs
the hand-written CUDA kernel `csrc/mfcc_core.cu` on CUDA tensors and
its plain PyTorch version, `reference_core`, on CPU tensors.  The
generator calls it for the canonical fft -> {mel -> dct, power}
subgraph when ``fused_mfcc=True`` and the samples lie on the GPU.

The kernel runs the DFT product on the tensor cores as 3xTF32: the
basis is split here, once per basis tensor, into TF32 hi and lo parts
(`split_tf32`) laid out for the kernel (`basis_layout`), and the mel
weights become a per-bin window of bands (`mel_table`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from aaltoasr_tpu_torch.ops.cuda_build import (
    SMEM_LIMIT, check, load_library)
from aaltoasr_tpu_torch.ops.tf32 import (  # noqa: F401  (names kept here)
    derived, device_index, num_sms, round_tf32, split_tf32)
from aaltoasr_tpu_torch.utils import profiling

SOURCE = "mfcc_core.cu"
CHUNK = 96        # basis columns per chunk (48 bins), as in the source
KPAD = 32         # basis rows are padded to the deepest k-slice
TILES = (128, 16)  # frames per block: batch shape, one-utterance shape


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.mfcc_core_launch.argtypes = [vp] * 8 + [i] * 12 + [vp]
    lib.mfcc_core_launch.restype = i
    lib.mfcc_core_smem_bytes.argtypes = [i, i]
    lib.mfcc_core_smem_bytes.restype = ctypes.c_size_t
    lib.mfcc_core_chunk_columns.restype = i
    if lib.mfcc_core_chunk_columns() != CHUNK:
        raise RuntimeError("mfcc_core: the library's chunk width differs "
                           f"from {CHUNK}")
    return lib


def reference_core(frames, dft_basis, mel_w, dct_m, magnitude=True,
                   root=False, with_power=True):
    """Plain PyTorch version of the kernel: the module ops' formulas,
    unfused.  [T, W] frames -> ([T, C] cepstra, [T, 1] log power or None)."""
    reim = frames.float() @ dft_basis
    K = dft_basis.shape[1] // 2
    re, im = reim[:, :K], reim[:, K:]
    power = re * re + im * im
    spec = torch.sqrt(power) if magnitude else power
    pw = (torch.log(spec.sum(dim=-1, keepdim=True) + 1e-10)
          if with_power else None)
    mel = spec @ mel_w
    v = torch.pow(mel, 0.1) if root else torch.log1p(mel)
    return v @ dct_m, pw


def basis_layout(dft_basis: torch.Tensor) -> torch.Tensor:
    """[W, 2K] basis ([cos | -sin] halves) -> [Np, Wp], transposed so a
    k-slice of a column is contiguous, with bin k's re column at row 2k
    and its im column at row 2k+1; rows padded with zeros to a multiple
    of CHUNK, columns to a multiple of KPAD."""
    W, two_k = dft_basis.shape
    K = two_k // 2
    out = dft_basis.new_zeros((-(-two_k // CHUNK) * CHUNK,
                               -(-W // KPAD) * KPAD))
    out[0:two_k:2, :W] = dft_basis[:, :K].T
    out[1:two_k:2, :W] = dft_basis[:, K:].T
    return out


def mel_table(mel_w: torch.Tensor, rows: int):
    """[K, M] mel weights -> (weights [rows, BW], first band [rows] int32):
    bin k adds spec * weights[k, q] to band first[k] + q, for the BW bands
    of the widest run of nonzero weights in a row (3 for the triangles).
    Rows past K are zero."""
    K, M = mel_w.shape
    nz = mel_w != 0
    live = nz.any(dim=1)
    first = torch.where(live, nz.int().argmax(dim=1), 0)
    last = torch.where(live, M - 1 - nz.flip(1).int().argmax(dim=1), 0)
    bw = max(int((last - first + 1).max()), 1) if K else 1
    band = first.clamp(max=M - bw)
    weights = mel_w.new_zeros((rows, bw))
    weights[:K] = mel_w.gather(
        1, band[:, None] + torch.arange(bw, device=mel_w.device))
    bands = torch.zeros(rows, dtype=torch.int32, device=mel_w.device)
    bands[:K] = band.to(torch.int32)
    return weights, bands


def prepared_tables(dft_basis, mel_w):
    """(basis hi, basis lo, mel weights, mel bands) for the kernel, made
    once per source table (`tf32.derived`)."""
    hi, lo = derived(dft_basis, lambda t: split_tf32(basis_layout(t)))
    rows = hi.shape[0] // 2
    return (hi, lo, *derived(mel_w, lambda t: mel_table(t, rows)))


def pick_tile(T: int, num_sms: int) -> int:
    """Frames per block: the batch tile once its blocks fill half the SMs
    (about 8,000 frames on an H100, where the two tiles take the same
    time), else the small tile, which spreads one utterance over more
    SMs."""
    big, small = TILES
    return big if 2 * -(-T // big) >= num_sms else small


def _check_inputs(frames, dft_basis, mel_w, dct_m):
    tensors = {"frames": frames, "dft_basis": dft_basis, "mel_w": mel_w,
               "dct_m": dct_m}
    for name, t in tensors.items():
        if t.device != frames.device:
            raise ValueError(f"mfcc_core: {name} is on {t.device}, frames "
                             f"on {frames.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"mfcc_core: {name} must be float32, "
                            f"got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"mfcc_core: {name} must be 2-D")
        if not t.is_contiguous():
            raise ValueError(f"mfcc_core: {name} must be contiguous")
    W = frames.shape[1]
    K = dft_basis.shape[1] // 2
    if (dft_basis.shape != (W, 2 * K) or mel_w.shape[0] != K
            or dct_m.shape[0] != mel_w.shape[1]):
        raise ValueError(
            f"mfcc_core: shapes do not chain: frames {tuple(frames.shape)}, "
            f"dft_basis {tuple(dft_basis.shape)}, mel_w "
            f"{tuple(mel_w.shape)}, dct_m {tuple(dct_m.shape)}")


def mfcc_core(frames, dft_basis, mel_w, dct_m, magnitude=True, root=False,
              with_power=True):
    """[T, W] frames -> ([T, C] cepstra, [T, 1] log power or None).

    CUDA tensors launch the kernel, with the frames per block picked from
    T (`pick_tile`); CPU tensors take `reference_core`.
    """
    if frames.device.type == "cpu":
        return reference_core(frames, dft_basis, mel_w, dct_m,
                              magnitude=magnitude, root=root,
                              with_power=with_power)
    if frames.device.type != "cuda":
        raise ValueError(f"mfcc_core: unsupported device {frames.device}")
    _check_inputs(frames, dft_basis, mel_w, dct_m)
    T, W = frames.shape
    M, C = dct_m.shape
    dev = frames.device
    tile = pick_tile(T, num_sms(device_index(dev)))
    lib = _lib()
    smem = lib.mfcc_core_smem_bytes(tile, M)
    if smem > SMEM_LIMIT:
        raise ValueError(f"mfcc_core: {M} mel bands need {smem} bytes of "
                         f"shared memory, above the {SMEM_LIMIT} limit")
    cep = torch.empty((T, C), dtype=torch.float32, device=dev)
    pw = (torch.empty((T, 1), dtype=torch.float32, device=dev)
          if with_power else None)
    if T == 0:
        return cep, pw
    if W % 4 or frames.data_ptr() % 16:
        # the kernel copies 16-byte vectors: pad rows to 4 floats
        padded = torch.zeros((T, -(-W // 4) * 4), dtype=torch.float32,
                             device=dev)
        padded[:, :W] = frames
        frames = padded
    hi, lo, mel_tab, mel_band = prepared_tables(dft_basis, mel_w)
    err = lib.mfcc_core_launch(
        frames.data_ptr(), hi.data_ptr(), lo.data_ptr(), mel_tab.data_ptr(),
        mel_band.data_ptr(), dct_m.data_ptr(), cep.data_ptr(),
        pw.data_ptr() if with_power else None,
        T, frames.shape[1], hi.shape[1], hi.shape[0], dft_basis.shape[1] // 2,
        M, C, mel_tab.shape[1], int(magnitude), int(root), int(with_power),
        tile, torch.cuda.current_stream(dev).cuda_stream)
    check(lib, err, "mfcc_core")
    profiling.count("k2.launches")
    return cep, pw
