"""Feature module ops on torch tensors.

Counterpart of `aaltoasr_tpu/frontend/modules.py`, every module type.
The numpy tables (window-folded DFT basis, mel triangles, DCT matrix,
VTLN and speech-rate interpolation matrices) are built with the
reference's own code; each ``apply`` is the same formula in torch.  The
alignment contract is the reference's: an op with context ``(left,
right)`` receives each source as ``[..., T_out + left + right, dim]``
and returns ``[..., T_out, out_dim]`` (time is the second-to-last axis,
so a leading batch axis passes through).

Matmuls run in IEEE float32: LNA codes step every 1/1820 in log-prob,
and TF32's ~1e-3 relative error would move them.  A float32 matmul in
torch is full precision unless a caller enables TF32 globally.
"""

from __future__ import annotations

import math

import numpy as np
import torch

class Op:
    """Base feature op.  Subclasses set out_dim/left/right at construction."""

    out_dim: int = 0
    left: int = 0
    right: int = 0

    def init_params(self) -> dict:
        """Runtime (speaker-dependent) parameters as numpy arrays."""
        return {}

    def set_parameters(self, config) -> dict:
        """A ModuleConfig parameter block (.spkc) as the params dict
        (FeatureModule::set_parameters, `aku/FeatureModule.hh:105-110`)."""
        raise ValueError(f"{type(self).__name__} takes no runtime parameters")

    def table(self, name: str, device) -> torch.Tensor:
        """The numpy table attribute ``name`` as a float32 tensor on
        ``device``, uploaded once per device."""
        cache = self.__dict__.setdefault("_tables", {})
        key = (name, torch.device(device))
        if key not in cache:
            cache[key] = torch.as_tensor(getattr(self, name),
                                         dtype=torch.float32, device=device)
        return cache[key]


class FFTOp(Op):
    """Short-time spectrum as a window-folded real-DFT matmul
    (FeatureModules.cc:488-566)."""

    def __init__(self, cfg, src_dims):
        (src_dim,) = src_dims
        self.src_dim = src_dim
        self.out_dim = src_dim // 2 + 1
        self.magnitude = cfg.get_int("magnitude", 1)
        self.log = cfg.get_int("log", 0)
        # hamming: .54 - .46*cos(2*pi*i/(N-1))  (FeatureModules.cc:490)
        i = np.arange(src_dim, dtype=np.float64)
        window = 0.54 - 0.46 * np.cos(2 * np.pi * i / (src_dim - 1.0))
        k = np.arange(self.out_dim, dtype=np.float64)
        phase = 2 * np.pi * np.outer(i, k) / src_dim
        # window-folded [N, 2K] basis: [cos | -sin] halves
        basis = np.concatenate(
            [np.cos(phase) * window[:, None],
             -np.sin(phase) * window[:, None]], axis=1)
        self.basis = basis.astype(np.float32)

    def apply(self, srcs, params):
        reim = srcs[0] @ self.table("basis", srcs[0].device)
        re = reim[..., :self.out_dim]
        im = reim[..., self.out_dim:]
        power = re * re + im * im
        out = torch.sqrt(power) if self.magnitude else power
        if self.log:
            out = torch.log(out)
        return out


def mel_dim(sample_rate: float) -> int:
    """Output dimension formula (FeatureModules.cc:779-781)."""
    return int((21 + 2) * math.log10(1 + sample_rate / 1400.0)
               / math.log10(1 + 16000 / 1400.0) - 2)


def mel_bin_edges(dim: int, sample_rate: float, src_dim: int) -> np.ndarray:
    """Bin edges in FFT-bin units (FeatureModules.cc:create_mel_bins);
    mel_step in float32 like the C code."""
    edges = dim + 2
    rate = np.float32(sample_rate)
    mel_step = np.float32(2595) * np.float32(
        np.log10(np.float32(1.0) + rate / np.float32(1400.0))) / np.float32(edges)
    i = np.arange(edges, dtype=np.float64)
    e = 1400.0 * (np.power(10.0, (i + 1) * float(mel_step) / 2595.0) - 1.0) * \
        (src_dim - 1) / float(sample_rate)
    return e.astype(np.float32)


def mel_weight_matrix(dim: int, sample_rate: float, src_dim: int) -> np.ndarray:
    """[src_dim, dim] triangle weights normalized by the per-bin sum
    (the loop structure of MelModule::generate, FeatureModules.cc:806-850)."""
    edges = mel_bin_edges(dim, sample_rate, src_dim)
    W = np.zeros((src_dim, dim), dtype=np.float64)
    for b in range(dim):
        beg = float(edges[b]) - 1.0
        end = float(edges[b + 1])
        t = int(max(math.ceil(beg), 0.0))
        ssum = 0.0
        while t < end:
            scale = (t - beg) / (end - beg)
            if t < src_dim:
                W[t, b] = scale
            ssum += scale
            t += 1
        beg2 = end
        end2 = float(edges[b + 2])
        while t < end2:
            scale = (end2 - t) / (end2 - beg2)
            if t < src_dim:
                W[t, b] = scale
            ssum += scale
            t += 1
        if ssum != 0:
            W[:, b] /= ssum
    return W.astype(np.float32)


class MelOp(Op):
    def __init__(self, cfg, src_dims, sample_rate):
        (src_dim,) = src_dims
        self.out_dim = mel_dim(sample_rate)
        self.root = cfg.get_int("root", 0)
        self.weights = mel_weight_matrix(self.out_dim, sample_rate, src_dim)

    def apply(self, srcs, params):
        v = srcs[0] @ self.table("weights", srcs[0].device)
        if self.root:
            # 10th root compression (FeatureModules.cc:839-842)
            return torch.pow(v, 0.1)
        return torch.log1p(v)  # log(val/sum + 1) (FeatureModules.cc:845)


class PowerOp(Op):
    """Natural log of the frame's summed spectrum (FeatureModules.cc:853-890)."""

    def __init__(self, cfg, src_dims):
        self.out_dim = 1

    def apply(self, srcs, params):
        return torch.log(srcs[0].sum(dim=-1, keepdim=True) + 1e-10)


class MelPowerOp(Op):
    """Natural log of the frame's summed exponentiated (log-mel) input
    (FeatureModules.cc:893-921)."""

    def __init__(self, cfg, src_dims):
        self.out_dim = 1

    def apply(self, srcs, params):
        return torch.log(torch.exp(srcs[0]).sum(dim=-1, keepdim=True) + 1e-10)


class DCTOp(Op):
    """Unnormalized cosine matrix that skips c0 (FeatureModules.cc:924-983)."""

    def __init__(self, cfg, src_dims):
        (src_dim,) = src_dims
        self.out_dim = cfg.get_int("dim", 12)
        if self.out_dim < 1:
            raise ValueError("DCTModule: Dimension must be > 0")
        self.zeroth = cfg.get_int("zeroth", 0)
        b = np.arange(src_dim, dtype=np.float64)
        rows = []
        if self.zeroth:
            rows.append(np.ones(src_dim))  # plain sum (FeatureModules.cc:962)
        n_cos = self.out_dim - (1 if self.zeroth else 0)
        for i in range(n_cos):
            rows.append(np.cos((i + 1) * (b + 0.5) * np.pi / src_dim))
        self.matrix = np.stack(rows, axis=1).astype(np.float32)  # [src, out]

    def apply(self, srcs, params):
        return srcs[0] @ self.table("matrix", srcs[0].device)


class DeltaOp(Op):
    """Regression deltas over +-width frames (FeatureModules.cc:986-1037)."""

    def __init__(self, cfg, src_dims):
        (src_dim,) = src_dims
        self.out_dim = src_dim
        self.width = cfg.get_int("width", 2)
        if self.width < 1:
            raise ValueError("DeltaModule: Delta width must be > 0")
        default_norm = 2 * self.width * (self.width + 1) * (2 * self.width + 1) / 6
        self.norm = cfg.get_float("normalization", float(default_norm))
        self.left = self.width
        self.right = self.width

    def apply(self, srcs, params):
        x = srcs[0]
        w = self.width
        T = x.shape[-2] - 2 * w
        out = torch.zeros(x.shape[:-2] + (T, self.out_dim), dtype=x.dtype,
                          device=x.device)
        for k in range(1, w + 1):
            out = out + k * (x[..., w + k: w + k + T, :]
                             - x[..., w - k: w - k + T, :])
        return out / self.norm


class NormalizationOp(Op):
    """(x - mean) * scale (FeatureModules.cc:1040-1140)."""

    def __init__(self, cfg, src_dims):
        (src_dim,) = src_dims
        self.out_dim = src_dim
        self._mean, self._scale = self._parse(cfg, src_dim)

    @staticmethod
    def _parse(cfg, dim):
        mean = np.zeros(dim, dtype=np.float32)
        scale = np.ones(dim, dtype=np.float32)
        m = cfg.get_float_vec("mean")
        if m is not None:
            if len(m) != dim:
                raise ValueError("NormalizationModule: Invalid mean dimension")
            mean = np.asarray(m, dtype=np.float32)
        if cfg.exists("var") and cfg.exists("scale"):
            raise ValueError("NormalizationModule: Both scale and var can not "
                             "be defined simultaneously")
        v = cfg.get_float_vec("var")
        if v is not None:
            if len(v) != dim:
                raise ValueError("Normalization module: Invalid variance dimension")
            scale = (1.0 / np.sqrt(np.asarray(v, dtype=np.float32)))
        else:
            s = cfg.get_float_vec("scale")
            if s is not None:
                if len(s) != dim:
                    raise ValueError("NormalizationModule: Invalid scale dimension")
                scale = np.asarray(s, dtype=np.float32)
        return mean, scale

    def init_params(self):
        return {"mean": self._mean, "scale": self._scale}

    def set_parameters(self, cfg):
        mean, scale = self._parse(cfg, self.out_dim)
        return {"mean": mean, "scale": scale}

    def apply(self, srcs, params):
        return (srcs[0] - params["mean"]) * params["scale"]


class LinTransformOp(Op):
    """y = A x + b (FeatureModules.cc:1143-1290)."""

    def __init__(self, cfg, src_dims):
        (src_dim,) = src_dims
        self.src_dim = src_dim
        self.out_dim = cfg.get_int("dim", src_dim)
        if self.out_dim < 1:
            raise ValueError("LinTransformModule: Dimension must be > 0")
        self._A, self._b = self._parse(cfg, self.out_dim, src_dim)

    @staticmethod
    def _parse(cfg, dim, src_dim):
        mat = cfg.get_float_vec("matrix")
        if mat is None:
            A = np.eye(dim, src_dim, dtype=np.float32)
        else:
            if len(mat) != dim * src_dim:
                raise ValueError("LinTransformModule: Invalid matrix dimension")
            A = np.asarray(mat, dtype=np.float32).reshape(dim, src_dim)
        bias = cfg.get_float_vec("bias")
        if bias is None:
            b = np.zeros(dim, dtype=np.float32)
        else:
            if len(bias) != dim:
                raise ValueError("LinTransformModule: Invalid bias dimension")
            b = np.asarray(bias, dtype=np.float32)
        return A, b

    def init_params(self):
        return {"matrix": self._A, "bias": self._b}

    def set_parameters(self, cfg):
        return dict(zip(("matrix", "bias"),
                        self._parse(cfg, self.out_dim, self.src_dim)))

    def apply(self, srcs, params):
        return srcs[0] @ params["matrix"].T + params["bias"]


class MergerOp(Op):
    """Feature-dim concatenation of the sources (FeatureModules.cc:1293-1365)."""

    def __init__(self, cfg, src_dims):
        self.out_dim = sum(src_dims)

    def apply(self, srcs, params):
        return torch.cat(srcs, dim=-1)


class MeanSubtractorOp(Op):
    """Moving-average cepstral mean subtraction over [-left, +right]
    (FeatureModules.cc:1368-1455)."""

    def __init__(self, cfg, src_dims):
        (src_dim,) = src_dims
        self.out_dim = src_dim
        l = cfg.get_int("left", 75)
        r = cfg.get_int("right", 75)
        if l < 0 or r < 0:
            raise ValueError("MeanSubtractorModule: context widths must be >= 0")
        self.left = l
        self.right = r
        self.width = l + r + 1

    def apply(self, srcs, params):
        x = srcs[0]
        T = x.shape[-2] - self.left - self.right
        # box filter via cumulative sum: mean[t] = sum(x[t .. t+width)) / width
        c = torch.cumsum(x, dim=-2)
        zero = torch.zeros(x.shape[:-2] + (1, x.shape[-1]), dtype=c.dtype,
                           device=c.device)
        c = torch.cat([zero, c], dim=-2)
        mean = (c[..., self.width: self.width + T, :] - c[..., 0:T, :]) / self.width
        return x[..., self.left: self.left + T, :] - mean


class ConcatOp(Op):
    """Frame splicing, frames ordered -left..+right
    (FeatureModules.cc:1458-1529)."""

    def __init__(self, cfg, src_dims):
        (src_dim,) = src_dims
        self.left = cfg.get_int("left", 0)
        self.right = cfg.get_int("right", 0)
        self.out_dim = src_dim * (self.left + self.right + 1)

    def apply(self, srcs, params):
        x = srcs[0]
        T = x.shape[-2] - self.left - self.right
        parts = [x[..., i: i + T, :] for i in range(self.left + self.right + 1)]
        return torch.cat(parts, dim=-1)


# ---------------------------------------------------------------------------
# vtln: the warped frequency axis as a precomputed matrix (VtlnModule,
# FeatureModules.cc: create_pwlin_bins/create_blin_bins/create_slapt_bins/
# create_sinc_coef_table + generate).  The table builders are the
# reference's, rounding through float32 at the same points.
# ---------------------------------------------------------------------------

def _sinc(x: float) -> float:
    if abs(x) < 1e-8:
        return 1.0
    y = math.pi * x
    return math.sin(y) / y


def vtln_bins(dim: int, warp_factor: float, use_pwlin: bool,
              pwlin_turn_point: float, slapt_params=None) -> np.ndarray:
    """Warped bin positions for each output bin (float32 like the reference)."""
    bins = np.zeros(dim, dtype=np.float64)
    if slapt_params is not None:
        for t in range(dim - 1):
            nf = math.pi * t / (dim - 1)
            v = float(t)
            for i, p in enumerate(slapt_params):
                v += p * math.sin((i + 1) * nf) * (dim - 1)
            bins[t] = v
    elif use_pwlin:
        border = np.float32(pwlin_turn_point) * np.float32(dim - 1)
        limit = False
        slope = point = 0.0
        for t in range(dim - 1):
            if not limit:
                bins[t] = warp_factor * t
            else:
                bins[t] = slope * t + point
            if not limit and (t >= border or bins[t] >= border):
                slope = (dim - 1 - bins[t]) / (dim - 1 - t)
                point = (1 - slope) * (dim - 1)
                limit = True
    else:
        for t in range(dim - 1):
            nf = math.pi * t / (dim - 1)
            bins[t] = t + 2 * math.atan2(
                (warp_factor - 1) * math.sin(nf),
                1 + (1 - warp_factor) * math.cos(nf)) / math.pi * (dim - 1)
    bins[dim - 1] = dim - 1
    return bins.astype(np.float32)


def vtln_matrix(dim: int, bins: np.ndarray, sinc_rad: int,
                lanczos: bool) -> tuple[np.ndarray, bool]:
    """[dim, dim] interpolation matrix W and whether output clamps at 0.

    sinc_rad > 0: windowed-sinc rows (clamped at 0 like the reference);
    otherwise 2-tap linear interpolation.
    """
    W = np.zeros((dim, dim), dtype=np.float64)
    if sinc_rad > 0:
        for b in range(dim):
            cent = int(bins[b] + 0.5)
            lo = max(cent - sinc_rad, 0)
            hi = min(cent + sinc_rad + 1, dim)
            for i in range(lo, hi):
                t = _sinc(float(i - bins[b]))
                if lanczos:
                    if abs(i - bins[b]) < sinc_rad:
                        t *= _sinc(float(i - bins[b]) / sinc_rad)
                    else:
                        t = 0.0
                W[b, i] = t
        return W.astype(np.float32), True
    for b in range(dim):
        p = math.ceil(bins[b]) - bins[b]
        W[b, int(math.floor(bins[b]))] += p
        W[b, int(math.ceil(bins[b]))] += 1 - p
    return W.astype(np.float32), False


def all_pass_blin_matrix(dim: int, warp_factor: float) -> np.ndarray:
    """Bilinear all-pass warp matrix in the cepstral-sequence domain
    (VtlnModule::create_all_pass_blin_transform,
    aku/FeatureModules.cc:1716-1756)."""
    alpha = warp_factor - 1.0
    q1 = np.zeros(dim, np.float64)
    q1[0] = -alpha
    if dim > 1:
        q1[1:] = (1.0 - alpha * alpha) * (alpha ** np.arange(dim - 1))
    q = np.zeros(dim, np.float64)
    q[0] = 1.0
    M = np.zeros((dim, dim), np.float64)
    M[0, 0] = 1.0
    for i in range(1, dim):
        q = np.convolve(q, q1)[:dim]
        M[0, i] = 2.0 * q[0]
        M[1:, i] = q[1:]
    return M


def all_pass_slapt_matrix(dim: int, params) -> np.ndarray:
    """Sine-log all-pass (SLAPT) warp matrix
    (VtlnModule::create_all_pass_slapt_transform,
    aku/FeatureModules.cc:1758-1866): the phase sequence exp(jF) is
    built by a 10-term Taylor series of the sine polynomial F."""
    params = np.asarray(params, np.float64)
    so = len(params)
    f1 = np.zeros(2 * so + 1, np.float64)
    for i in range(so):
        f1[i] = -params[so - i - 1] * np.pi / 2.0
        f1[i + so + 1] = params[i] * np.pi / 2.0
    q = np.zeros(2 * dim + 1, np.float64)
    cur_f = np.array([1.0])
    cur_center = 0
    cur_m = 1.0
    for i in range(11):
        if i > 0:
            cur_m /= i
        low1 = max(0, dim - cur_center)
        high1 = min(2 * dim + 1, dim + cur_center + 1)
        js = np.arange(low1, high1)
        q[js] += cur_m * cur_f[js - (dim + 1) + cur_center + 1]
        cur_f = np.convolve(cur_f, f1)
        cur_center = (len(cur_f) - 1) // 2
    q = q[:-2]                               # symmetric, length 2*dim-1
    q1 = q.copy()
    M = np.zeros((dim, dim), np.float64)
    M[0, 0] = 1.0
    for i in range(1, dim):
        M[0, i] = 2.0 * q[dim - 1]
        j = np.arange(1, dim)
        M[1:, i] = q[dim + j - 1] + q[dim - j - 1]
        q = np.convolve(q, q1)[dim - 1:3 * dim - 2]
    return M


def all_pass_vtln_matrix(dim: int, seq_matrix: np.ndarray) -> np.ndarray:
    """[dim, dim] spectral-domain interpolation matrix: IDCT @ M @ DCT
    (VtlnModule::set_all_pass_transform, aku/FeatureModules.cc:
    1868-1904)."""
    i = np.arange(dim)[:, None]
    j = np.arange(dim)[None, :]
    dct = np.cos(i * (j + 0.5) * np.pi / dim)
    idct = np.cos((i + 0.5) * j * np.pi / dim) * 2.0 / dim
    idct[:, 0] = 1.0 / dim
    return (idct @ (seq_matrix @ dct)).astype(np.float32)


class VtlnOp(Op):
    """Frequency warping as one matmul by the warp matrix, a runtime
    parameter (a .spkc ``warp_factor`` or ``slapt_coef`` rebuilds it on
    the host); the sinc and all-pass tables clamp the output at zero."""

    def __init__(self, cfg, src_dims):
        (src_dim,) = src_dims
        self.out_dim = src_dim
        self.use_pwlin = bool(cfg.get_int("pwlin_vtln", 0))
        self.turn_point = cfg.get_float("pwlin_turnpoint", 0.8)
        self.use_slapt = bool(cfg.get_int("slapt", 0))
        if self.use_pwlin and self.use_slapt:
            raise ValueError("VtlnModule: Can not use both pwlin_vtln and slapt!")
        self.sinc_rad = cfg.get_int("sinc_interpolation_rad", 8)
        self.all_pass = cfg.get_int("all-pass", 0)
        if self.use_pwlin and self.all_pass:
            raise ValueError(
                "VtlnModule: Can not use both pwlin_vtln and all-pass!")
        self.lanczos = cfg.get_int("lanczos_window",
                                   0 if self.all_pass else 1) > 0
        if self.lanczos and self.all_pass:
            raise ValueError(
                "VtlnModule: Can not use both lanczos_window and "
                "all-pass!")
        self._matrix, self._clamp = self._build(
            1.0, [0.0] if self.use_slapt else None)

    def _build(self, warp_factor, slapt):
        if self.all_pass:
            if slapt is not None:
                seq = all_pass_slapt_matrix(self.out_dim, slapt)
            else:
                seq = all_pass_blin_matrix(self.out_dim, warp_factor)
            # the all-pass interpolation rows clamp at zero like the
            # sinc path (VtlnModule::generate, FeatureModules.cc:1919)
            return all_pass_vtln_matrix(self.out_dim, seq), True
        bins = vtln_bins(self.out_dim, warp_factor, self.use_pwlin,
                         self.turn_point, slapt)
        return vtln_matrix(self.out_dim, bins, self.sinc_rad, self.lanczos)

    def init_params(self):
        return {"warp_matrix": self._matrix}

    def set_parameters(self, cfg):
        if self.use_slapt:
            slapt = cfg.get_float_vec("slapt_coef", [0.0])
            W, _ = self._build(1.0, slapt)
        else:
            wf = cfg.get_float("warp_factor", 1.0)
            W, _ = self._build(wf, None)
        return {"warp_matrix": W}

    def apply(self, srcs, params):
        # a warp matrix per batch row ([B, F, F], a VTLN grid) or one
        out = srcs[0] @ params["warp_matrix"].mT
        if self._clamp:
            out = torch.clamp(out, min=0.0)
        return out


class SRNormOp(Op):
    """Speech-rate normalization: Lanczos resampling of a stacked frame
    window (`aku/FeatureModules.cc` SRNormModule::set_speech_rate +
    ::generate).  The per-rate coefficients form one [in_frames,
    out_frames] matrix: an einsum over the reshaped window, then relu
    (the reference clamps at 0)."""

    def __init__(self, cfg, src_dims):
        (src_dim,) = src_dims
        self.in_frames = cfg.get_int("in_frames", 0)
        self.out_frames = cfg.get_int("out_frames", 0)
        if not self.in_frames or not self.out_frames:
            raise ValueError(
                "SRNormModule: Must set both in_frames and out_frames.")
        if src_dim % self.in_frames != 0:
            raise ValueError("SRNormModule: in_frames does not match "
                             "with the input dimension")
        self.frame_dim = src_dim // self.in_frames
        self.out_dim = self.out_frames * self.frame_dim
        self.lanczos_order = cfg.get_int("lanczos_order", 4)
        if self.lanczos_order < 1:
            raise ValueError(
                "SRNormModule: lanczos_order must be positive.")
        self.default_rate = cfg.get_float("speech_rate", 1.0)

    def _weights(self, rate: float) -> np.ndarray:
        """[in_frames, out_frames] Lanczos matrix (set_speech_rate)."""
        a = self.lanczos_order
        in_cent = (self.in_frames - 1) / 2.0
        out_cent = (self.out_frames - 1) / 2.0
        W = np.zeros((self.in_frames, self.out_frames), np.float32)
        for i in range(self.out_frames):
            tp = (i - out_cent) / rate + in_cent
            cent = int(np.round(tp))
            lo = max(cent - a, 0)
            hi = min(cent + a + 1, self.in_frames)
            for j in range(lo, hi):
                if abs(j - tp) < a:
                    W[j, i] = _sinc(j - tp) * _sinc((j - tp) / a)
        return W

    def init_params(self):
        return {"weights": self._weights(self.default_rate)}

    def set_parameters(self, cfg):
        rate = cfg.get_float("speech_rate", 1.0)
        return {"weights": self._weights(rate)}

    def apply(self, srcs, params):
        x = srcs[0]
        xf = x.reshape(x.shape[:-1] + (self.in_frames, self.frame_dim))
        y = torch.einsum("...if,io->...of", xf, params["weights"])
        return torch.relu(y).reshape(x.shape[:-1] + (self.out_dim,))


class QuantEqOp(Op):
    """Channel-dependent quantile equalization (QuantEqModule::generate):

    y_k = qmax_k * alpha_k * (x_k/qmax_k)^(gamma_k + (1-alpha_k)*(x_k/qmax_k))

    and the identity until alpha/gamma/quant_max runtime parameters
    arrive (the ``identity`` switch)."""

    def __init__(self, cfg, src_dims):
        (src_dim,) = src_dims
        self.out_dim = src_dim

    def init_params(self):
        return {"alpha": np.ones(self.out_dim, np.float32),
                "gamma": np.ones(self.out_dim, np.float32),
                "quant_max": np.ones(self.out_dim, np.float32),
                "identity": np.ones((), np.float32)}

    def set_parameters(self, cfg):
        alpha = cfg.get_float_vec("alpha")
        gamma = cfg.get_float_vec("gamma")
        qmax = cfg.get_float_vec("quant_max")
        if not (alpha and gamma and qmax):
            return self.init_params()
        return {"alpha": np.asarray(alpha, np.float32),
                "gamma": np.asarray(gamma, np.float32),
                "quant_max": np.asarray(qmax, np.float32),
                "identity": np.zeros((), np.float32)}

    def apply(self, srcs, params):
        x = srcs[0]
        r = x / params["quant_max"]
        expo = params["gamma"] + (1.0 - params["alpha"]) * r
        y = params["quant_max"] * params["alpha"] * torch.pow(
            torch.clamp(r, min=1e-10), expo)
        return torch.where(params["identity"] > 0.5, x, y)


_OPS = {
    "fft": FFTOp,
    "power": PowerOp,
    "melpower": MelPowerOp,
    "dct": DCTOp,
    "delta": DeltaOp,
    "normalization": NormalizationOp,
    "lin_transform": LinTransformOp,
    "merge": MergerOp,
    "mean_subtractor": MeanSubtractorOp,
    "concat": ConcatOp,
    "vtln": VtlnOp,
    "quanteq": QuantEqOp,
    "sr_norm": SRNormOp,
}


def build_op(mtype: str, cfg, src_dims: list, sample_rate: float) -> Op:
    if mtype == "mel":
        return MelOp(cfg, src_dims, sample_rate)
    if mtype in _OPS:
        return _OPS[mtype](cfg, src_dims)
    raise ValueError(f"Unknown module type '{mtype}'")
