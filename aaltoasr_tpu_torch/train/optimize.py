"""Gradient-based model optimization (optmodel / LmbfgsOptimize).

Reference: `aku/optmodel.cc` (criterion gradients from ML/MMI/MPE
statistics dumps in an unconstrained parameter space) and
`aku/LmbfgsOptimize.cc` (limited-memory BFGS with the inverse-Hessian
history persisted in an optimization state file between invocations —
each iteration is a fresh `stats` collection).

Re-designed rather than translated: parameters pack into one flat
vector (means, log-variances, mixture-weight logits), the criterion is
written as an explicit function of the sufficient statistics so the
gradient is one vectorized expression (the reference's tests verify it
against automatic differentiation of the same objective), and the
two-loop L-BFGS recursion runs on the packed vector.  State persists as
an .npz.

Sufficient-statistics objective per Gaussian g with effective stats
(gamma, m1, m2) — the part of the EM auxiliary that depends on the
parameters:

    F_g = gamma*(C_g) - 1/2 sum_d (m2 - 2 mu m1 + gamma mu^2) * p
    C_g = 1/2 sum_d log p_d          (reference constant, no 2 pi)

    dF/dmu      = (m1 - gamma*mu) * p
    dF/dlog var = ((m2 - 2 mu m1 + gamma mu^2) * p - gamma) / 2
    dF/dtheta_i = gamma_i - w_i * sum_j gamma_j     (softmax logits)

Host copy of `aaltoasr_tpu/train/optimize.py`.
"""

from __future__ import annotations

import numpy as np

from aaltoasr_tpu_torch.formats.model_io import HmmModel
from aaltoasr_tpu_torch.train.accumulators import (
    HmmStats, ML_BUF, MMI_BUF, MPE_DEN_BUF, MPE_NUM_BUF)


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

def pack_params(model: HmmModel) -> np.ndarray:
    """means | log covars | per-mixture weight logits (log w)."""
    parts = [model.means.ravel(),
             np.log(np.maximum(model.covars, 1e-10)).ravel()]
    for _, w in model.mixtures:
        parts.append(np.log(np.maximum(np.asarray(w, np.float64),
                                       1e-10)))
    return np.concatenate(parts)


def unpack_params(model: HmmModel, x: np.ndarray,
                  minvar: float = 0.09) -> HmmModel:
    G, D = model.means.shape
    means = x[:G * D].reshape(G, D).copy()
    covars = np.maximum(np.exp(x[G * D:2 * G * D].reshape(G, D)),
                        minvar)
    off = 2 * G * D
    mixtures = []
    for idx, w in model.mixtures:
        k = len(w)
        logits = x[off:off + k]
        off += k
        e = np.exp(logits - logits.max())
        mixtures.append((np.asarray(idx, np.int32), e / e.sum()))
    return HmmModel(
        dim=model.dim, cov_type=model.cov_type, means=means,
        covars=covars, mixtures=mixtures, phones=model.phones,
        transitions=model.transitions, durations=model.durations,
        full_covars=model.full_covars, gauss_kind=model.gauss_kind)


# ---------------------------------------------------------------------------
# criterion gradient from statistics
# ---------------------------------------------------------------------------

def effective_stats(model: HmmModel, stats: HmmStats,
                    ml_weight: float = 0.0, mmi_weight: float = 0.0,
                    mpe_weight: float = 0.0, gsmooth: float = 0.0,
                    msmooth: float = 0.0):
    """Signed per-Gaussian (gamma, m1, m2) and per-mixture gamma under
    the weighted criterion ml*ML + mmi*(num-den) + mpe*(num-den),
    with gsmooth/msmooth adding ML smoothing to the MPE part
    (optmodel.cc --gsmooth/--msmooth)."""
    G, D = model.means.shape
    S = len(model.mixtures)
    K = max(len(w) for _, w in model.mixtures)

    def buf(i):
        if i not in stats.buffers:
            return (np.zeros(G), np.zeros((G, D)), np.zeros((G, D)),
                    np.zeros((S, K)))
        b = stats.buffers[i]
        mg = np.zeros((S, K))
        mk = min(K, b.mix_gamma.shape[1])
        mg[:, :mk] = b.mix_gamma[:S, :mk]
        return (b.gamma[:G], b.mean_acc[:G], b.sec_acc[:G], mg)

    ml = buf(ML_BUF)
    mmi = buf(MMI_BUF)
    mpn = buf(MPE_NUM_BUF)
    mpd = buf(MPE_DEN_BUF)

    out = []
    for i in range(4):
        v = (ml_weight * ml[i]
             + mmi_weight * (ml[i] - mmi[i])
             + mpe_weight * (mpn[i] - mpd[i]))
        smooth = gsmooth if i < 3 else msmooth
        if mpe_weight != 0.0 and smooth != 0.0:
            # ML smoothing of the discriminative stats, scaled so a
            # smoothing weight of 1 matches the ML occupancy mass
            tot = float(np.sum(ml[0])) or 1.0
            v = v + smooth * mpe_weight * ml[i] / tot * float(
                np.sum(np.abs(mpn[0] - mpd[0])))
        out.append(v)
    return out


def criterion_grad(model: HmmModel, stats: HmmStats, **weights):
    """Gradient of the statistics objective in packed space."""
    gamma, m1, m2, mixg = effective_stats(model, stats, **weights)
    mu = model.means
    p = 1.0 / np.maximum(model.covars, 1e-10)
    gam = gamma[:, None]

    g_mu = (m1 - gam * mu) * p
    quad = m2 - 2 * mu * m1 + gam * mu * mu
    g_logv = 0.5 * (quad * p - gam)

    g_mix = []
    for s, (idx, w) in enumerate(model.mixtures):
        k = len(w)
        gi = mixg[s, :k]
        g_mix.append(gi - np.asarray(w) * gi.sum())
    return np.concatenate([g_mu.ravel(), g_logv.ravel()] + g_mix)


# ---------------------------------------------------------------------------
# limited-memory BFGS with persistent state
# ---------------------------------------------------------------------------

class LbfgsState:
    """Two-loop-recursion L-BFGS over invocations (LmbfgsOptimize.cc);
    the (s, y) history and the previous point live in an .npz."""

    def __init__(self, max_updates: int = 4, init_scale: float = 1.0):
        self.max_updates = max_updates
        self.init_scale = init_scale
        self.s: list = []
        self.y: list = []
        self.prev_x = None
        self.prev_g = None

    # -- persistence -------------------------------------------------
    def save(self, path: str) -> None:
        np.savez(path,
                 max_updates=self.max_updates,
                 init_scale=self.init_scale,
                 num_pairs=len(self.s),
                 **{f"s{i}": v for i, v in enumerate(self.s)},
                 **{f"y{i}": v for i, v in enumerate(self.y)},
                 prev_x=(self.prev_x if self.prev_x is not None
                         else np.zeros(0)),
                 prev_g=(self.prev_g if self.prev_g is not None
                         else np.zeros(0)))

    @classmethod
    def load(cls, path: str) -> "LbfgsState":
        z = np.load(path)
        st = cls(int(z["max_updates"]), float(z["init_scale"]))
        n = int(z["num_pairs"])
        st.s = [z[f"s{i}"] for i in range(n)]
        st.y = [z[f"y{i}"] for i in range(n)]
        st.prev_x = z["prev_x"] if z["prev_x"].size else None
        st.prev_g = z["prev_g"] if z["prev_g"].size else None
        return st

    # -- update ------------------------------------------------------
    def direction(self, x: np.ndarray, grad: np.ndarray) -> np.ndarray:
        """Ascent direction H * grad (we maximize the criterion).

        Internally the standard minimization two-loop recursion on
        g = -grad; the returned step is its negation."""
        g = -np.asarray(grad, dtype=np.float64)
        if self.prev_x is not None:
            s = x - self.prev_x
            y = g - self.prev_g
            if float(s @ y) > 1e-12:            # curvature condition
                self.s.append(s)
                self.y.append(y)
                if len(self.s) > self.max_updates:
                    self.s.pop(0)
                    self.y.pop(0)
        self.prev_x = np.asarray(x, dtype=np.float64).copy()
        self.prev_g = g.copy()

        q = g.copy()
        alpha = []
        for s, y in zip(reversed(self.s), reversed(self.y)):
            rho = 1.0 / float(s @ y)
            a = rho * float(s @ q)
            q -= a * y
            alpha.append((rho, a))
        if self.s:
            s, y = self.s[-1], self.y[-1]
            q *= float(s @ y) / float(y @ y)
        else:
            q *= self.init_scale
        for (rho, a), s, y in zip(reversed(alpha),
                                  self.s, self.y):
            b = rho * float(y @ q)
            q += (a - b) * s
        return -q


def optimization_step(x: np.ndarray, grad: np.ndarray,
                      state: LbfgsState, limit: float = 1.0):
    """One ascent step with the max-parameter-change limit
    (optmodel.cc --limit)."""
    d = state.direction(x, grad)
    mx = float(np.max(np.abs(d)))
    if mx > limit:
        d = d * (limit / mx)
    return x + d
