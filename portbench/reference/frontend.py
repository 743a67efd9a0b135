"""Plain MFCC features: the reference the program's frontend is held to.

The configuration is `configs/*.json`'s ``features``: 16 kHz audio,
frames of 256 samples every 128 with pre-emphasis 0.97 (border frames
copied), a Hamming-windowed DFT magnitude, 21 mel bands compressed by
log(1 + v), 12 cepstra without c0, the log of the summed spectrum, and
regression deltas and accelerations of width 2: 39 features
(`aku/FeatureModules.cc`).  The tables follow the reference's formulas
(mel edges in float32 as its C code computes them) and everything
runs in ``dtype`` on the device given: float64 for the reference,
float32 with TF32 products for the control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

RATE = 16000
WINDOW = 256
HOP = 128
PRE_EMPH = 0.97
CEPS = 12
DELTA_WIDTH = 2
CONTEXT = 2 * DELTA_WIDTH        # frames of context each side (delta, accel)


def num_frames(num_samples: int) -> int:
    return int((num_samples - WINDOW - 1) / HOP) + 1


def mel_bands(rate: float = RATE) -> int:
    return int((21 + 2) * math.log10(1 + rate / 1400.0)
               / math.log10(1 + 16000 / 1400.0) - 2)


def mel_weights(dim: int, rate: float, src_dim: int) -> np.ndarray:
    """[src_dim, dim] triangles, each normalized by its sum."""
    edges_n = dim + 2
    r = np.float32(rate)
    step = np.float32(2595) * np.float32(
        np.log10(np.float32(1.0) + r / np.float32(1400.0))) / np.float32(
            edges_n)
    i = np.arange(edges_n, dtype=np.float64)
    edges = (1400.0 * (np.power(10.0, (i + 1) * float(step) / 2595.0) - 1.0)
             * (src_dim - 1) / float(rate)).astype(np.float32)
    W = np.zeros((src_dim, dim))
    for b in range(dim):
        beg, end = float(edges[b]) - 1.0, float(edges[b + 1])
        t = int(max(math.ceil(beg), 0.0))
        total = 0.0
        while t < end:
            v = (t - beg) / (end - beg)
            if t < src_dim:
                W[t, b] = v
            total += v
            t += 1
        beg2, end2 = end, float(edges[b + 2])
        while t < end2:
            v = (end2 - t) / (end2 - beg2)
            if t < src_dim:
                W[t, b] = v
            total += v
            t += 1
        if total != 0:
            W[:, b] /= total
    return W


def tables(device, dtype) -> dict:
    """DFT basis [W, 2K] (window folded in), mel [K, M], DCT [M, C]."""
    i = np.arange(WINDOW, dtype=np.float64)
    window = 0.54 - 0.46 * np.cos(2 * np.pi * i / (WINDOW - 1.0))
    K = WINDOW // 2 + 1
    ph = 2 * np.pi * np.outer(i, np.arange(K)) / WINDOW
    basis = np.concatenate([np.cos(ph) * window[:, None],
                            -np.sin(ph) * window[:, None]], axis=1)
    M = mel_bands()
    b = np.arange(M, dtype=np.float64)
    dct = np.stack([np.cos((c + 1) * (b + 0.5) * np.pi / M)
                    for c in range(CEPS)], axis=1)
    return {k: torch.as_tensor(v, dtype=dtype, device=device)
            for k, v in (("basis", basis), ("mel", mel_weights(M, RATE, K)),
                         ("dct", dct))}


def _deltas(x: torch.Tensor) -> torch.Tensor:
    """Regression deltas over +-2 frames; [N + 4, d] -> [N, d]."""
    w = DELTA_WIDTH
    T = x.shape[0] - 2 * w
    out = torch.zeros((T, x.shape[1]), dtype=x.dtype, device=x.device)
    for k in range(1, w + 1):
        out = out + k * (x[w + k:w + k + T] - x[w - k:w - k + T])
    return out / (2 * w * (w + 1) * (2 * w + 1) / 6)


def features(samples: torch.Tensor, tab: dict,
             dtype=torch.float64) -> torch.Tensor:
    """[S] samples of one utterance -> [T, 39] features in ``dtype``."""
    s = samples.to(dtype)
    T = num_frames(s.shape[0])
    pre = s[1:] - PRE_EMPH * s[:-1]
    frames = pre.unfold(0, WINDOW, HOP)[:T]                  # [T, W]
    K = WINDOW // 2 + 1
    reim = frames @ tab["basis"]
    mag = torch.sqrt(reim[:, :K] ** 2 + reim[:, K:] ** 2)
    cep = torch.log1p(mag @ tab["mel"]) @ tab["dct"]
    power = torch.log(mag.sum(-1, keepdim=True) + 1e-10)
    base = torch.cat([cep, power], dim=1)                    # [T, 13]
    idx = torch.arange(-CONTEXT, T + CONTEXT,
                       device=s.device).clamp(0, T - 1)
    ext = base[idx]                                          # border copies
    delta = _deltas(ext)                                     # [T + 4, 13]
    accel = _deltas(delta)                                   # [T, 13]
    c = DELTA_WIDTH
    return torch.cat([base, delta[c:c + T], accel], dim=1)
