"""Extended Baum-Welch updates for discriminative (MMI/MPE) training.

Host copy of `aaltoasr_tpu/train/ebw.py`.

Reference: `aku/Distributions.cc:502-716` (Gaussian EBW with per-Gaussian
D search) and `:2284-2402` (Woodland & Povey '02 mixture-weight
iteration).  Diagonal-covariance path, vectorized over the pool:

* c = gamma_num - gamma_den, mu~ = m1_num - m1_den, Sigma~ = m2_num -
  m2_den
* per-dimension positivity bound: largest real root of
  a2 D^2 + a1 D + a0 with a2 = old_cov, a1 = Sigma~ + c(old_cov +
  old_mean^2) - 2 mu~ old_mean, a0 = c Sigma~ - mu~^2
  (Distributions.cc:559-581)
* D = max(C1 * gamma_den + tau, C2 * min_d)  (defaults C1=C2=2,
  estimate.cc:133-134)
* new_mean = (mu~ + D old_mean) / (c + D)
  new_cov  = (Sigma~ + D(old_cov + old_mean^2)) / (c + D) - new_mean^2,
  floored at minvar.
"""

from __future__ import annotations

import numpy as np

from aaltoasr_tpu_torch.formats.model_io import HmmModel
from aaltoasr_tpu_torch.models.hmm import TransitionTable
from aaltoasr_tpu_torch.train.accumulators import (
    HmmStats, ML_BUF, MMI_BUF, MPE_DEN_BUF, MPE_NUM_BUF)


def ebw_min_d(old_means, old_covars, c, mu_t, sigma_t) -> np.ndarray:
    """[G] per-Gaussian minimum D keeping every dimension's variance
    positive (largest real root per dim, maxed over dims)."""
    a2 = old_covars
    a1 = (sigma_t + c[:, None] * (old_covars + old_means ** 2)
          - 2 * mu_t * old_means)
    a0 = c[:, None] * sigma_t - mu_t ** 2
    disc = a1 * a1 - 4 * a0 * a2
    with np.errstate(invalid="ignore", divide="ignore"):
        root = np.where(disc >= 0,
                        (-a1 + np.sqrt(np.maximum(disc, 0))) / (2 * a2),
                        0.0)
    return np.maximum(root, 0.0).max(axis=1)


def _ebw_solution(old_means, old_covars, c, mu_t, sigma_t, d):
    denom = c + d
    safe = np.where(np.abs(denom) > 1e-10, denom, 1.0)
    new_mean = (mu_t + d[:, None] * old_means) / safe[:, None]
    new_cov = ((sigma_t + d[:, None] * (old_covars + old_means ** 2))
               / safe[:, None] - new_mean ** 2)
    return new_mean, new_cov


def ebw_constrained_d(old_means, old_covars, c, mu_t, sigma_t,
                      d0, max_kld: float) -> np.ndarray:
    """Grow each Gaussian's D until the parameter change fits the KLD
    budget (Gaussian::ConstrainedEBWSolver::constrained_update,
    Distributions.cc:464-495): kld = max(mean KLD, diagonal cov KLD),
    doubling then bisection — all Gaussians in lockstep instead of the
    reference's per-Gaussian scalar search."""
    D = old_means.shape[1]

    def kld(d):
        nm, nc = _ebw_solution(old_means, old_covars, c, mu_t,
                               sigma_t, d)
        nc = np.maximum(nc, 1e-10)
        km = 0.5 * (((nm - old_means) ** 2) / old_covars).sum(axis=1)
        kc = 0.5 * ((nc / old_covars
                     + np.log(old_covars / nc)).sum(axis=1) - D)
        return np.maximum(km, kc)

    need = kld(d0) > max_kld
    if not need.any():
        return d0
    lo = d0.copy()
    hi = np.maximum(d0, 1e-10)
    for _ in range(200):                        # doubling phase
        over = need & (kld(hi) > max_kld)
        if not over.any():
            break
        lo = np.where(over, hi, lo)
        hi = np.where(over, hi * 2, hi)
    for _ in range(60):                         # bisection (kld is
        mid = 0.5 * (lo + hi)                   # decreasing in D)
        over = kld(mid) > max_kld
        lo = np.where(need & over, mid, lo)
        hi = np.where(need & ~over, mid, hi)
    return np.where(need, hi, d0)


def ebw_gaussian_update(old_means, old_covars, num_gamma, num_m1, num_m2,
                        den_gamma, den_m1, den_m2,
                        c1: float = 2.0, c2: float = 2.0,
                        tau: float = 0.0, minvar: float = 0.1,
                        max_kld: float = 0.0, fixed_d=None):
    """Vectorized EBW update.

    Returns (means, covars, realized_d, min_d) where min_d is the
    C2-scaled minimum D (Gaussian::get_minimum_d, Distributions.cc:634)
    and realized_d the D actually used.  fixed_d (per Gaussian, <0 =
    unset) overrides the default C1*den_gamma+tau (Distributions.cc:
    635-638, estimate --ebwd)."""
    c = num_gamma - den_gamma
    mu_t = num_m1 - den_m1
    sigma_t = num_m2 - den_m2
    min_d = ebw_min_d(old_means, old_covars, c, mu_t, sigma_t)
    default_d = c1 * den_gamma + tau
    if fixed_d is not None:
        default_d = np.where(np.asarray(fixed_d) >= 0, fixed_d, default_d)
    d = np.maximum(default_d, c2 * min_d)
    if max_kld > 0:
        d = ebw_constrained_d(old_means, old_covars, c, mu_t, sigma_t,
                              d, max_kld)
    denom = c + d
    safe = np.where(np.abs(denom) > 1e-10, denom, 1.0)
    new_mean = (mu_t + d[:, None] * old_means) / safe[:, None]
    new_cov = ((sigma_t + d[:, None] * (old_covars + old_means ** 2))
               / safe[:, None] - new_mean ** 2)
    new_cov = np.maximum(new_cov, minvar)
    ok = np.abs(denom) > 1e-10
    new_mean = np.where(ok[:, None], new_mean, old_means)
    new_cov = np.where(ok[:, None], new_cov, old_covars)
    return new_mean, new_cov, d, c2 * min_d


def mmi_mixture_weights(num_gamma, den_gamma, old_weights,
                        max_iter: int = 1000, tol: float = 1e-5):
    """Woodland & Povey '02 iterative weight update
    (Distributions.cc:2297-2401), exact reference semantics including the
    move-halfway heuristics and the 1e-8 weight floor."""
    K = len(old_weights)
    if K == 1:
        return np.asarray([1.0])
    w = np.asarray(old_weights, dtype=np.float64).copy()
    old_w = np.asarray(old_weights, dtype=np.float64)
    currfval = 0.0
    for it in range(max_iter):
        oldfval = currfval
        for i in range(K):
            prev = w.copy()
            partsum = prev.sum() - prev[i]
            if partsum <= 0:
                continue
            a = den_gamma[i] / old_w[i]
            for j in range(K):
                if j != i:
                    a -= den_gamma[j] * prev[j] / (old_w[j] * partsum)
            b = -a - num_gamma.sum()
            cq = num_gamma[i]
            disc = b * b - 4 * a * cq
            if a == 0 or disc < 0:
                continue
            sol1 = (-b - np.sqrt(disc)) / (2 * a)
            if not np.isnan(sol1):
                if sol1 <= 0:
                    w[i] = w[i] / 2.0
                elif sol1 >= 1.0:
                    w[i] = w[i] + (1 - w[i]) / 2.0
                else:
                    w[i] = sol1
                w[i] = max(w[i], 1e-8)
            norm_m = (1 - w[i]) / partsum
            for j in range(K):
                if j != i:
                    w[j] *= norm_m
        currfval = float(np.sum(
            num_gamma * np.log(np.maximum(w, 1e-30))
            - den_gamma * w / old_w))
        if it > 0 and abs(oldfval - currfval) <= tol:
            break
    return w


def estimate_mmi(model: HmmModel, table: TransitionTable,
                 stats: HmmStats, c1: float = 2.0, c2: float = 2.0,
                 tau: float = 0.0, minvar: float = 0.1,
                 mode: str = "mmi", max_kld: float = 0.0,
                 update_mixtures: bool = True, fixed_d=None,
                 d_out: dict | None = None) -> HmmModel:
    """Discriminative M-step from num/den buffers -> new model.

    fixed_d: optional [G] per-Gaussian D overrides (estimate --ebwd).
    d_out: if given, receives ``realized_d`` and ``min_d`` [G] arrays
    (estimate --write-ebwd)."""
    if mode == "mmi":
        num, den = stats.buffers[ML_BUF], stats.buffers[MMI_BUF]
    else:  # mpe
        num, den = stats.buffers[MPE_NUM_BUF], stats.buffers[MPE_DEN_BUF]
    G = model.num_gaussians
    has_data = (num.gamma[:G] > 0) | (den.gamma[:G] > 0)
    means, covars, realized_d, min_d = ebw_gaussian_update(
        model.means, model.covars,
        num.gamma[:G], num.mean_acc[:G], num.sec_acc[:G],
        den.gamma[:G], den.mean_acc[:G], den.sec_acc[:G],
        c1=c1, c2=c2, tau=tau, minvar=minvar, max_kld=max_kld,
        fixed_d=fixed_d)
    if d_out is not None:
        d_out["realized_d"] = realized_d
        d_out["min_d"] = min_d
    means = np.where(has_data[:, None], means, model.means)
    covars = np.where(has_data[:, None], covars, model.covars)

    mixtures = []
    for s, (idx, w) in enumerate(model.mixtures):
        k = len(idx)
        if update_mixtures and num.mix_gamma[s, :k].sum() > 0:
            w_new = mmi_mixture_weights(
                num.mix_gamma[s, :k], den.mix_gamma[s, :k], w)
            mixtures.append((idx.copy(), w_new / w_new.sum()))
        else:
            mixtures.append((idx.copy(), w.copy()))

    return HmmModel(
        dim=model.dim, cov_type=model.cov_type, means=means,
        covars=covars, full_covars=dict(model.full_covars),
        gauss_kind=list(model.gauss_kind), mixtures=mixtures,
        phones=list(model.phones),
        transitions={k: list(v) for k, v in model.transitions.items()},
        durations=model.durations)
