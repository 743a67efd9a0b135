"""Constrained line search (CLS) discriminative update step.

Reference: `aku/clsstep.cc` — one CLS iteration over model parameters:
mixture weights then Gaussian means/covariances move toward the
discriminative critical point (or along the gradient when no critical
point exists), with the step length clipped by per-parameter-group KLD
limits.  This implements the default path (`cls_step(kldcs=false)`:
`original_cls_mixture_step`, `clsstep.cc:1570-1714`, and
`original_cls_mean_cov_step`, `clsstep.cc:1714-1915`), vectorized over
the Gaussian pool instead of per-PDF loops.

Criterion statistics: MMI uses ML_BUF - MMI_BUF, MPE uses MPE_NUM_BUF
(`clsstep.cc:1586-1590`).

Host copy of `aaltoasr_tpu/train/clsstep.py`.
"""

from __future__ import annotations

import math

import numpy as np

from aaltoasr_tpu_torch.formats.model_io import HmmModel
from aaltoasr_tpu_torch.train.accumulators import (
    HmmStats, ML_BUF, MMI_BUF, MPE_NUM_BUF)


def _safe_log(x):
    return np.log(np.maximum(x, 1e-300))


def cls_mixture_step(model: HmmModel, stats: HmmStats, mode: str,
                     weight_kld_limit: float, info: int = 0) -> list:
    """One CLS step on every mixture's weights
    (original_cls_mixture_step).  Returns the new mixtures list."""
    if mode == "mmi":
        gam = (stats.buffers[ML_BUF].mix_gamma
               - stats.buffers[MMI_BUF].mix_gamma)
    else:
        gam = stats.buffers[MPE_NUM_BUF].mix_gamma

    new_mixtures = []
    for s, (idx, orig_w) in enumerate(model.mixtures):
        k = len(idx)
        orig = np.asarray(orig_w, dtype=np.float64)
        g = gam[s, :k].astype(np.float64)
        norm = g.sum()
        pos = bool(np.all(g > 0))
        neg = bool(np.all(g < 0))

        if pos and norm != 0:
            # critical point is a maximum: head straight for it
            search_dir = g / norm - orig
        elif neg and norm != 0:
            # critical point is a minimum: move away from it
            search_dir = orig - g / norm
        else:
            # projected gradient (onto the sum-zero plane)
            search_dir = g / orig
            normal_c = 1.0 / math.sqrt(k)
            search_dir = search_dir - (search_dir * normal_c).sum() \
                * normal_c

        # approximative KLD: sum dir^2 / w  (clsstep.cc:1641-1648)
        kld_est = float(np.sum(search_dir ** 2 / orig))
        if pos and not neg and kld_est < weight_kld_limit:
            # at a maximum and already inside the KLD budget: full step
            step = 1.0
        elif kld_est > 0:
            step = math.sqrt(weight_kld_limit / kld_est)
        else:
            new_mixtures.append((idx.copy(), orig.copy()))
            continue
        new_w = orig + step * search_dir
        # clip step so no weight leaves (1e-6, 1]
        rescale = False
        for j in range(k):
            if search_dir[j] == 0:
                continue
            if new_w[j] <= 1e-6:
                step = min(step, (1e-6 - orig[j]) / search_dir[j])
                rescale = True
            elif new_w[j] > 1:
                step = min(step, (1.0 - orig[j]) / search_dir[j])
                rescale = True
        if rescale:
            step = max(step, 0.0)
            new_w = orig + step * search_dir
        norm1 = np.abs(new_w).sum()
        new_w = np.clip(new_w / norm1, 1e-6, 1.0)
        new_mixtures.append((idx.copy(), new_w))
    return new_mixtures


def cls_mean_cov_step(model: HmmModel, stats: HmmStats, mode: str,
                      mean_kld_limit: float, cov_kld_limit: float,
                      min_var: float = 0.09, info: int = 0):
    """One CLS step on all pool Gaussians (original_cls_mean_cov_step),
    vectorized.  Returns (new_means, new_covars)."""
    G, D = model.means.shape
    if mode == "mmi":
        num = stats.buffers[ML_BUF]
        den = stats.buffers[MMI_BUF]
        d_gamma = (num.gamma - den.gamma)[:G]
        d_m1 = (num.mean_acc - den.mean_acc)[:G]
        d_m2 = (num.sec_acc - den.sec_acc)[:G]
    else:
        num = stats.buffers[MPE_NUM_BUF]
        d_gamma = num.gamma[:G].copy()
        d_m1 = num.mean_acc[:G].copy()
        d_m2 = num.sec_acc[:G].copy()

    mean = np.asarray(model.means, dtype=np.float64)
    cov = np.asarray(model.covars, dtype=np.float64)

    # ---- mean update
    zero = d_gamma == 0
    g_safe = np.where(zero, 1.0, d_gamma)
    # gradient direction (zero-gamma rows): (m1 - mean*gamma)/cov
    grad_dir = (d_m1 - mean * d_gamma[:, None]) / cov
    grad_scale = np.sum(grad_dir ** 2 / cov, axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        gs = np.where(grad_scale > 0,
                      np.sqrt(mean_kld_limit / np.maximum(grad_scale,
                                                          1e-300)), 0.0)
    grad_step = grad_dir * gs[:, None]
    # critical-point direction: sign(gamma) * (target - mean)
    target_mean = d_m1 / g_safe[:, None]
    sign = np.where(d_gamma > 0, 1.0, -1.0)
    crit_dir = sign[:, None] * (target_mean - mean)
    # parameter KLD of the move: sum dir^2/cov (x2 of the 0.5 dmean^2/cov
    # per-dim terms, clsstep.cc:1797-1800,1461-1464)
    crit_scale = np.sum(crit_dir ** 2 / cov, axis=1)
    need = ((d_gamma < 0) & (crit_scale > 0)) | \
        (crit_scale >= mean_kld_limit)
    with np.errstate(divide="ignore", invalid="ignore"):
        cs = np.where(need,
                      np.sqrt(mean_kld_limit
                              / np.maximum(crit_scale, 1e-300)), 1.0)
    crit_step = crit_dir * cs[:, None]
    mean_step = np.where(zero[:, None], grad_step, crit_step)
    new_mean = mean + mean_step

    # ---- covariance update (in log variance domain)
    # per-dim critical-point existence: gamma*m2 >= m1^2 for ALL dims
    pos = ~zero & np.all(d_gamma[:, None] * d_m2 >= d_m1 ** 2, axis=1)
    log_cov = _safe_log(np.maximum(min_var, cov))
    with np.errstate(divide="ignore", invalid="ignore"):
        target_cov = _safe_log(d_m2 / g_safe[:, None]
                               - (d_m1 / g_safe[:, None]) ** 2)
    crit_dir_c = target_cov - log_cov
    crit_scale_c = np.sum(crit_dir_c ** 2, axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        csc = np.where(crit_scale_c > cov_kld_limit,
                       np.sqrt(cov_kld_limit
                               / np.maximum(crit_scale_c, 1e-300)), 1.0)
    crit_step_c = crit_dir_c * csc[:, None]

    # gradient for log(sigma^2) (clsstep.cc:1873-1886)
    expc = np.exp(log_cov)
    grad_nz = (d_m2 - d_m1 ** 2 / g_safe[:, None]
               - d_gamma[:, None] * expc) / (2 * expc)
    grad_z = (d_m2 - 2 * d_m1 * mean + d_gamma[:, None] * mean ** 2
              - d_gamma[:, None] * expc) / (2 * expc)
    grad_dir_c = np.where(zero[:, None], grad_z, grad_nz)
    grad_scale_c = np.sum(grad_dir_c ** 2, axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        gsc = np.where(grad_scale_c > 0,
                       np.sqrt(cov_kld_limit
                               / np.maximum(grad_scale_c, 1e-300)), 0.0)
    grad_step_c = grad_dir_c * gsc[:, None]

    cov_step = np.where(pos[:, None], crit_step_c, grad_step_c)
    new_cov = np.maximum(min_var, np.exp(log_cov + cov_step))
    return new_mean, new_cov


def cls_step(model: HmmModel, stats: HmmStats, mode: str,
             weight_kld_limit: float = 0.1, mean_kld_limit: float = 0.1,
             cov_kld_limit: float = 0.1, min_var: float = 0.09,
             info: int = 0) -> HmmModel:
    """Full CLS iteration (cls_step(kldcs=false), clsstep.cc:3132-3141):
    mixture-weight step then mean/covariance step."""
    mixtures = cls_mixture_step(model, stats, mode, weight_kld_limit,
                                info)
    means, covars = cls_mean_cov_step(model, stats, mode, mean_kld_limit,
                                      cov_kld_limit, min_var, info)
    return HmmModel(
        dim=model.dim, cov_type=model.cov_type, means=means,
        covars=covars, full_covars=dict(model.full_covars),
        gauss_kind=list(model.gauss_kind), mixtures=mixtures,
        phones=list(model.phones),
        transitions={k: list(v) for k, v in model.transitions.items()},
        durations=model.durations)
