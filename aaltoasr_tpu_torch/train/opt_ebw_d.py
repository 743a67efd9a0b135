"""Per-Gaussian EBW-D optimization (QuickProp in log-D domain).

Host copy of `aaltoasr_tpu/train/opt_ebw_d.py`.

Reference: `aku/opt_ebw_d.cc` — optimizes the EBW smoothing constants D
(per Gaussian, or clustered per mixture / phoneme-state / globally)
against a control criterion (ML/MMI/MPE) evaluated on a development set,
using gradient/QuickProp steps on log D.  The heavy per-Gaussian loops
(`extract_gradient`, `opt_ebw_d.cc:316-516`) vectorize over the pool.

File formats kept byte-compatible:
  * D file  — text, one ``D min_D max_D`` per line (`read_d_file`,
    `opt_ebw_d.cc:137-165`; written by `estimate --write-ebwd`,
    `estimate.cc:79-102`)
  * QP state — binary ``int32 size + float64[size]`` for prev_step then
    prev_gradient (`write_qp_state`, `opt_ebw_d.cc:684-715`)
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass

import numpy as np

from aaltoasr_tpu_torch.train.accumulators import (
    HmmStats, ML_BUF, MMI_BUF, MPE_NUM_BUF, MPE_DEN_BUF)

MAX_UPDATE_STEP = 0.182        # opt_ebw_d.cc:41 (max 1.2*D)
QP_MAX_STEP_INCREASE = 2.0     # opt_ebw_d.cc:42
MINVAR = 0.1                   # opt_ebw_d.cc "FIXME: minvar"


# ---------------------------------------------------------------- file IO

def read_d_file(path, n: int):
    """Text D file -> (d, min_d, max_d) float64 arrays [n]."""
    d = np.zeros(n)
    mind = np.zeros(n)
    maxd = np.zeros(n)
    with open(path) as f:
        for i in range(n):
            fields = f.readline().split()
            if len(fields) != 3:
                raise ValueError(f"Invalid format in D file {path}")
            v, mn, mx = (float(x) for x in fields)
            if mn < 0 or (mx > 0 and mx < mn):
                raise ValueError(f"Invalid value in D file {path}")
            d[i] = max(v, 0.0)
            mind[i] = mn
            maxd[i] = mx
    return d, mind, maxd


def write_d_file(path, d, mind, maxd) -> None:
    with open(path, "w") as f:
        for v, mn, mx in zip(d, mind, maxd):
            f.write(f"{v:g} {mn:g} {mx:g}\n")


def read_qp_state(path):
    """Binary QP state -> (prev_step, prev_gradient) or None."""
    try:
        with open(path, "rb") as f:
            out = []
            for _ in range(2):
                raw = f.read(4)
                if len(raw) < 4:
                    return None
                (size,) = struct.unpack("<i", raw)
                vec = np.frombuffer(f.read(8 * size), dtype="<f8")
                if len(vec) < size:
                    return None
                out.append(vec.astype(np.float64))
        return out[0], out[1]
    except OSError:
        return None


def write_qp_state(path, prev_step, gradient) -> None:
    with open(path, "wb") as f:
        for vec in (prev_step, gradient):
            f.write(struct.pack("<i", len(vec)))
            f.write(np.asarray(vec, dtype="<f8").tobytes())


# ------------------------------------------------------------- clustering

def gaussian_clusters(model, mode: str) -> np.ndarray:
    """[G] cluster index per pool Gaussian (opt_ebw_d.cc:71-133)."""
    G = model.num_gaussians
    cluster = np.full(G, -1, dtype=np.int64)
    if mode == "none":
        return np.arange(G, dtype=np.int64)
    if mode == "global":
        return np.zeros(G, dtype=np.int64)
    if mode == "mix":
        for s, (idx, _w) in enumerate(model.mixtures):
            cluster[np.asarray(idx, dtype=np.int64)] = s
        return cluster
    if mode == "pho":
        # phoneme/state clustering: label "<center>.<state_pos>"
        index: dict = {}
        for phone in model.phones:
            center = phone.label
            if "-" in center:
                center = center.split("-", 1)[1]
            if "+" in center:
                center = center.split("+", 1)[0]
            for j, state in enumerate(phone.states):
                label = f"{center}.{j}"
                cid = index.setdefault(label, len(index))
                idx, _w = model.mixtures[state]
                cluster[np.asarray(idx, dtype=np.int64)] = cid
        return cluster
    raise ValueError(f"unknown clustering mode {mode!r}")


# --------------------------------------------------------------- gradient

def _criterion_stats(stats: HmmStats, mode: str, mpe_gradient: bool):
    """(gamma [G], m1 [G,D], m2 [G,D]) for a criterion
    (opt_ebw_d.cc:346-420)."""
    if mode == "mpe":
        num = stats.buffers[MPE_NUM_BUF]
        gamma = num.gamma.copy()
        m1 = num.mean_acc.copy()
        m2 = num.sec_acc.copy()
        if not mpe_gradient:
            den = stats.buffers[MPE_DEN_BUF]
            gamma -= den.gamma
            m1 -= den.mean_acc
            m2 -= den.sec_acc
        return gamma, m1, m2
    ml = stats.buffers[ML_BUF]
    gamma = ml.gamma.copy()
    m1 = ml.mean_acc.copy()
    m2 = ml.sec_acc.copy()
    if mode == "mmi":
        den = stats.buffers[MMI_BUF]
        gamma -= den.gamma
        m1 -= den.mean_acc
        m2 -= den.sec_acc
    return gamma, m1, m2


def gauss_gradient(model, control_stats: HmmStats, train_stats: HmmStats,
                   gaussian_d: np.ndarray, ac_scale: float,
                   control_mode: str, train_mode: str,
                   mpe_gradient: bool = False) -> np.ndarray:
    """d(control score)/dD per pool Gaussian (extract_gradient,
    `opt_ebw_d.cc:316-461`), vectorized over [G, D]."""
    G = model.num_gaussians
    c_gamma, c_m1, c_m2 = _criterion_stats(control_stats, control_mode,
                                           mpe_gradient)
    t_gamma, t_m1, t_m2 = _criterion_stats(train_stats, train_mode,
                                           mpe_gradient)
    c_gamma, c_m1, c_m2 = c_gamma[:G], c_m1[:G], c_m2[:G]
    t_gamma, t_m1, t_m2 = t_gamma[:G], t_m1[:G], t_m2[:G]

    mean = np.asarray(model.means, dtype=np.float64)
    cov = np.asarray(model.covars, dtype=np.float64)

    d_div = t_gamma + gaussian_d
    d_div = np.where(np.abs(d_div) < 1e-5,
                     np.where(d_div < 0, -1e-5, 1e-5), d_div)

    new_mean = (t_m1 + gaussian_d[:, None] * mean) / d_div[:, None]
    new_cov = ((gaussian_d[:, None] * (cov + mean ** 2) + t_m2)
               / d_div[:, None]) - new_mean ** 2
    clipped = new_cov < MINVAR
    new_cov = np.maximum(new_cov, MINVAR)

    mean_grad = -ac_scale * (c_m1 - new_mean * c_gamma[:, None]) / new_cov
    cov_grad = -ac_scale * (
        (c_m2 - 2 * c_m1 * new_mean
         + c_gamma[:, None] * new_mean ** 2
         - c_gamma[:, None] * new_cov) / (2 * new_cov ** 2))
    # dimensions pinned at the variance floor while shrinking contribute
    # no covariance gradient (opt_ebw_d.cc:438-440)
    cov_grad = np.where(clipped & (new_cov < cov), 0.0, cov_grad)

    dd2 = d_div ** 2
    dmu = (-t_m1 + t_gamma[:, None] * mean) / dd2[:, None]
    dsigma = ((t_gamma[:, None] * (mean ** 2 + cov) - t_m2)
              / dd2[:, None] - 2 * new_mean * dmu)
    return np.sum(mean_grad * dmu + cov_grad * dsigma, axis=1)


def combine_gradient(gauss_grad, cluster, d_params, gaussian_d,
                     gaussian_min_d, gaussian_max_d,
                     param_min_d, param_max_d,
                     relaxed_min: bool = False, gmin_gamma: float = 0.0,
                     log_prior: float = 0.0):
    """Cluster combination + log-domain/prior gradient
    (opt_ebw_d.cc:456-516).  Returns (gradient [P], n_discarded)."""
    P = len(d_params)
    grad = np.zeros(P)
    dtol = 0.1
    active = ((gaussian_d > gaussian_min_d)
              & ((gaussian_max_d <= 0) | (gaussian_d < gaussian_max_d))
              & (np.abs(d_params[cluster] - gaussian_d) < dtol))
    np.add.at(grad, cluster[active], gauss_grad[active])
    n_disc = int(np.sum(~active))
    if relaxed_min:
        relax = ~active & (gaussian_d <= gaussian_min_d)
        n_disc -= int(np.sum(relax))
        dp = d_params[cluster]
        beta = np.where(gaussian_min_d > 0,
                        1.0 / ((1 - gmin_gamma)
                               * np.maximum(gaussian_min_d, 1e-30)), 0.0)
        deriv = np.where((dp < gaussian_min_d) & (gaussian_min_d > 0),
                         np.exp(beta * (dp - gaussian_min_d)), 1.0)
        np.add.at(grad, cluster[relax], (gauss_grad * deriv)[relax])
    grad = grad * d_params
    if log_prior != 0:
        ok = (param_min_d > 0) & (param_max_d > 0)
        with np.errstate(divide="ignore", invalid="ignore"):
            grad = np.where(
                ok,
                grad + (log_prior / P) / (np.log(param_max_d)
                                          - np.log(param_min_d)),
                grad)
    return grad, n_disc


# ------------------------------------------------------- optimization step

def qp_step(d_params, gradient, prev_step, prev_gradient,
            param_min_d, param_max_d, qp_epsilon: float = 0.02):
    """QuickProp step in log-D (qp_optimization_step,
    `opt_ebw_d.cc:518-602`).  Returns (new_d, new_prev_step, converged)."""
    tiny = 1e-4
    grad_update = -qp_epsilon * gradient
    step = grad_update.copy()
    have_prev = np.abs(prev_step) > tiny
    with np.errstate(divide="ignore", invalid="ignore"):
        hessian = np.where(have_prev,
                           (gradient - prev_gradient) / prev_step, 0.0)
        hess_step = np.where(hessian > 0, -gradient / hessian, 0.0)
    pos_h = have_prev & (hessian > 0)
    smooth = pos_h & (gradient * prev_gradient > 0)
    step = np.where(pos_h, hess_step, step)
    step = np.where(smooth, hess_step + grad_update, step)
    neg_h = have_prev & (hessian <= 0)
    step = np.where(neg_h & (np.abs(step) < np.abs(prev_step)),
                    prev_step, step)
    # acceleration limit
    cap = np.abs(QP_MAX_STEP_INCREASE * prev_step)
    over = have_prev & (np.abs(step) > cap)
    with np.errstate(divide="ignore", invalid="ignore"):
        step = np.where(over, step * cap / np.abs(step), step)
    # absolute step limit
    step = np.clip(step, -MAX_UPDATE_STEP, MAX_UPDATE_STEP)
    # wrong direction or tiny -> gradient step
    bad = (step * gradient > 0) | (np.abs(step) < tiny)
    step = np.where(bad, grad_update, step)

    old_log = np.log(d_params)
    old = d_params.copy()
    new_d = np.exp(old_log + step)
    new_d = np.maximum(new_d, param_min_d)
    new_d = np.where((param_max_d > 0) & (new_d > param_max_d),
                     param_max_d, new_d)
    new_prev_step = np.log(new_d) - old_log
    converged = float(np.mean((new_d - old) ** 2)) < 0.001
    return new_d, new_prev_step, converged


def gradient_step(d_params, gradient, param_min_d, param_max_d,
                  step_size: float):
    """Plain first gradient step (gradient_step, opt_ebw_d.cc:628-658)."""
    step = np.clip(-step_size * gradient,
                   -MAX_UPDATE_STEP, MAX_UPDATE_STEP)
    old_log = np.log(d_params)
    new_d = np.exp(old_log + step)
    new_d = np.maximum(new_d, param_min_d)
    new_d = np.where((param_max_d > 0) & (new_d > param_max_d),
                     param_max_d, new_d)
    return new_d, np.log(new_d) - old_log


def realize_gaussian_d(d_params, cluster, gaussian_min_d, gaussian_max_d,
                       relaxed_min: bool = False,
                       gmin_gamma: float = 0.0) -> np.ndarray:
    """Clustered D -> per-Gaussian D respecting Gaussian limits
    (set_gaussian_parameters, opt_ebw_d.cc:168-196)."""
    d = d_params[cluster].astype(np.float64)
    below = d < gaussian_min_d
    if relaxed_min:
        alpha = (1 - gmin_gamma) * gaussian_min_d
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            relaxed = (alpha * np.exp((d - gaussian_min_d)
                                      / np.maximum(alpha, 1e-30))
                       + gmin_gamma * gaussian_min_d)
        d = np.where(below, relaxed, d)
    else:
        d = np.where(below, gaussian_min_d, d)
    d = np.where((gaussian_max_d > 0) & (d > gaussian_max_d),
                 gaussian_max_d, d)
    return d


def init_cluster_d_from_gaussians(cluster, n_params, gaussian_d,
                                  gaussian_min_d, gaussian_max_d):
    """Cluster D init = min over member Gaussians
    (set_optimization_parameters, opt_ebw_d.cc:268-296)."""
    d = np.full(n_params, np.inf)
    mn = np.full(n_params, np.inf)
    mx = np.full(n_params, -1.0)
    np.minimum.at(d, cluster, gaussian_d)
    np.minimum.at(mn, cluster, gaussian_min_d)
    np.maximum.at(mx, cluster, gaussian_max_d)
    d[~np.isfinite(d)] = 0.0
    mn[~np.isfinite(mn)] = 0.0
    return d, mn, mx
