"""Generalized KLD-constrained search (clsstep --kldcs).

Reference: `aku/clsstep.cc` — `kld_constrained_mixture_update`
(:2495-2695) and `kld_constrained_mean_covariance_update` (:2695-3013)
with their solver hierarchy (:317-1390).  For every mixture /
Gaussian the update solves the KKT system "maximize criterion s.t.
KLD(new, old) <= limit" by a line search over the Lagrange multiplier
lambda; when the critical-point update is invalid it falls back to a
linearized (gradient) solver.  An optional criterion-change/KLD ratio
(--ckratio) further grows lambda until the improvement per KLD is
sufficient.

Host-side NumPy: these are sequential scalar root searches per
mixture/Gaussian (the reference runs them the same way); the heavy
per-dimension math is vectorized.

Host copy of `aaltoasr_tpu/train/clsstep_kld.py`.
"""

from __future__ import annotations

import math

import numpy as np

from aaltoasr_tpu_torch.formats.model_io import HmmModel
from aaltoasr_tpu_torch.train.accumulators import (
    HmmStats, ML_BUF, MMI_BUF, MPE_NUM_BUF)


# ------------------------------------------------------- lambda search

def _bisect(f, lo, f_lo, hi, f_hi, target, value_acc, param_acc,
            iters=200):
    """Find p with f(p) ~ target inside a bracketing interval."""
    for _ in range(iters):
        if abs(hi - lo) < param_acc:
            break
        mid = 0.5 * (lo + hi)
        f_mid = f(mid)
        if abs(f_mid - target) < value_acc:
            return mid
        # keep the side that still brackets the target
        if (f_lo - target) * (f_mid - target) <= 0:
            hi, f_hi = mid, f_mid
        else:
            lo, f_lo = mid, f_mid
    return hi if abs(f_hi - target) < abs(f_lo - target) else lo


def search_lambda(f, initial, limit):
    """Find lambda with f(lambda) ~ limit (search_lambda,
    clsstep.cc:255-315).  f is decreasing in lambda."""
    cur = initial
    c = f(cur)
    if abs(c - limit) < 1e-6:
        return cur
    guard = 0
    if c < limit:
        while c < limit and cur > 0:
            up_v, up_b = c, cur
            cur = cur / 2.0
            if cur < 1e-20:
                cur = 0.0
            c = f(cur)
            guard += 1
            if guard > 100:
                return cur
        if c < limit:
            return cur
        lo_v, lo_b = c, cur
    else:
        while c > limit:
            lo_v, lo_b = c, cur
            cur = cur * 2.0 if cur > 0 else 1.0
            c = f(cur)
            guard += 1
            if guard > 100:
                return cur
        up_v, up_b = c, cur
    return _bisect(f, lo_b, lo_v, up_b, up_v, limit, 1e-6,
                   1e-12 * abs(up_b - lo_b))


# ------------------------------------------------------ mixture solvers

def _solve_weight_ebw(w0, gamma, abs_gamma, lam, c):
    """One weight from the EBW-style critical equation
    (CriticalMixtureWeightSolver, clsstep.cc:317-497).  Returns the
    weight or None on failure."""
    min_w = 1e-4

    if lam == 0:
        denom = abs_gamma - gamma + 2 * c * w0
        if denom <= 0:
            return 1.0
        return min(max(w0 * (abs_gamma + gamma) / denom, min_w), 1.0)

    def g(p):
        return (((abs_gamma + gamma) / p - (abs_gamma - gamma) / w0) / 2.0
                - lam * (math.log(p / w0) + 1) - c)

    lower_f = g(min_w)
    upper_f = g(1.0)
    if lower_f < upper_f:       # should be decreasing
        return None
    if lower_f < 0:
        return min_w
    if upper_f > 0:
        return 1.0
    return min(max(_bisect(g, min_w, lower_f, 1.0, upper_f, 0.0,
                           1e-8, 1e-12), min_w), 1.0)


class CriticalMixtureSolver:
    """EBW-style critical-point weights under a lambda*KLD penalty
    (CriticalMixtureSolver, clsstep.cc:552-887)."""

    def __init__(self, w0, gammas, abs_gammas, k_ratio):
        self.w0 = np.asarray(w0, dtype=np.float64)
        self.g = np.asarray(gammas, dtype=np.float64)
        self.ag = np.asarray(abs_gammas, dtype=np.float64)
        self.k_ratio = k_ratio
        self.eval_kld = True

    def _solve_c(self, lam, c):
        """Weights for a given sum-constraint c; (weights, norm) or
        None on failure."""
        w = np.empty(len(self.w0))
        for j in range(len(self.w0)):
            wj = _solve_weight_ebw(self.w0[j], self.g[j], self.ag[j],
                                   lam, c)
            if wj is None:
                return None
            w[j] = wj
        return w, float(w.sum())

    def solve_weights(self, lam):
        """Weights summing to 1 for a given lambda, or None.
        norm(c) is non-increasing in c, so bracket then bisect
        (the reference's solve_weights bracketing dance,
        clsstep.cc:656-886, simplifies under that monotonicity)."""
        out = self._solve_c(lam, 0.0)
        if out is None:
            return None
        w, norm = out
        if abs(norm - 1.0) < 1e-10:
            return w / norm
        lo_c, hi_c = 0.0, 0.0
        if norm < 1:            # need smaller c
            hi_c, hi_n = 0.0, norm
            step = 1.0
            for _ in range(100):
                lo_c = hi_c - step
                out = self._solve_c(lam, lo_c)
                if out is None:
                    return None
                _, lo_n = out
                if lo_n >= 1:
                    break
                step *= 2
            else:
                return None
            lo_n_, hi_n_ = lo_n, hi_n
        else:                   # need larger c
            lo_c, lo_n = 0.0, norm
            step = 1.0
            for _ in range(100):
                hi_c = lo_c + step
                out = self._solve_c(lam, hi_c)
                if out is None:
                    return None
                _, hi_n = out
                if hi_n <= 1:
                    break
                step *= 2
            else:
                return None
            lo_n_, hi_n_ = lo_n, hi_n

        def norm_at(c):
            out = self._solve_c(lam, c)
            return out[1] if out is not None else 0.0

        c = _bisect(norm_at, lo_c, norm_at(lo_c), hi_c, norm_at(hi_c),
                    1.0, 1e-3, 1e-12 * max(abs(hi_c - lo_c), 1e-30))
        out = self._solve_c(lam, c)
        if out is None:
            return None
        w, norm = out
        if abs(1 - norm) > 0.01:
            return None
        return w / norm

    def objective(self, w):
        return float(np.sum(
            ((self.g + self.ag) * np.log(w)
             - (self.ag - self.g) * w / self.w0) / 2.0))

    def evaluate(self, lam):
        """KLD at lambda (or ratio criterion when eval_kld is False)."""
        w = self.solve_weights(lam)
        if w is None:
            return float(len(self.w0))          # overestimate
        kld = float(np.sum(w * np.log(w / self.w0)))
        if not self.eval_kld:
            f_change = self.objective(w) - self.objective(self.w0)
            return self.k_ratio * kld - f_change
        return kld


class LinearMixtureSolver:
    """Linearized mixture solver (LinearMixtureSolver,
    clsstep.cc:887-1007): w_j = w0_j exp((grad_j - c)/lambda - 1)."""

    def __init__(self, w0, grad, k_ratio):
        self.w0 = np.asarray(w0, dtype=np.float64)
        self.grad = np.asarray(grad, dtype=np.float64)
        self.k_ratio = k_ratio
        self.eval_kld = True

    def _solve_c(self, lam, c):
        w = np.clip(self.w0 * np.exp((self.grad - c) / lam - 1.0),
                    1e-8, 1.0)
        return w, float(w.sum())

    def solve_weights(self, lam):
        w, norm = self._solve_c(lam, 0.0)
        lo_c = hi_c = 0.0
        step = 1.0
        if norm < 1:
            for _ in range(100):
                lo_c = hi_c - step
                _, n = self._solve_c(lam, lo_c)
                if n >= 1:
                    break
                step *= 2
        elif norm > 1:
            for _ in range(100):
                hi_c = lo_c + step
                _, n = self._solve_c(lam, hi_c)
                if n <= 1:
                    break
                step *= 2

        def norm_at(c):
            return self._solve_c(lam, c)[1]

        c = _bisect(norm_at, lo_c, norm_at(lo_c), hi_c, norm_at(hi_c),
                    1.0, 1e-4, 1e-12 * max(abs(hi_c - lo_c), 1e-30))
        w, norm = self._solve_c(lam, c)
        return w / norm

    def objective(self, w):
        return float(np.sum(w * self.grad))

    def evaluate(self, lam):
        w = self.solve_weights(lam)
        kld = float(np.sum(w * np.log(w / self.w0)))
        if not self.eval_kld:
            f_change = self.objective(w) - self.objective(self.w0)
            return self.k_ratio * kld - f_change
        return kld


# --------------------------------------------------- mean / cov solvers

class MeanSolver:
    """Critical mean under lambda*KLD (CriticalMeanSolver/MeanSolver,
    clsstep.cc:1036-1133)."""

    def __init__(self, mean0, cov0, d_gamma, d_m1, k_ratio=0.0):
        self.mean0 = mean0
        self.cov0 = cov0
        self.g = d_gamma
        self.m1 = d_m1
        self.k_ratio = k_ratio
        self.eval_kld = True

    def solve(self, lam):
        return (self.m1 + lam * self.mean0) / max(self.g + lam, 1e-20)

    def evaluate(self, lam):
        m = self.solve(lam)
        kld = 0.5 * float(np.sum((m - self.mean0) ** 2 / self.cov0))
        if self.eval_kld:
            return kld
        t = m - self.mean0
        f_change = float(np.sum(
            (t * (self.m1 - self.g * self.mean0)
             - t * t * self.g / 2.0) / self.cov0))
        return self.k_ratio * kld - f_change


class CovSolver:
    """Critical / linearized covariance under lambda*KLD (CovSolver,
    clsstep.cc:1247-1390)."""

    MAX, LINEAR = 0, 1

    def __init__(self, mean0, cov0, d_gamma, d_m1, d_m2, min_var,
                 k_ratio=0.0):
        self.mean0 = mean0
        self.cov0 = cov0
        self.g = d_gamma
        self.m1 = d_m1
        self.m2 = d_m2
        self.minv = min_var
        self.k_ratio = k_ratio
        self.solver = self.MAX
        self.eval_kld = True
        self.grad0 = ((d_m2 - 2 * d_m1 * mean0 + d_gamma * mean0 ** 2
                       - d_gamma * cov0) / (2 * cov0 ** 2))

    def solve(self, lam):
        if self.solver == self.MAX:
            temp = self.m2 - 2 * self.m1 * self.mean0 \
                + self.g * self.mean0 ** 2
            if lam == 0:
                cov = temp / self.g
            else:
                m0_l = -self.g + lam
                l_c = lam / self.cov0
                disc = np.sqrt(np.maximum(m0_l ** 2 + 4 * l_c * temp,
                                          0.0))
                cov = (m0_l + disc) / (2 * l_c)
        else:
            cov = lam * self.cov0 / (lam - 2 * self.cov0 * self.grad0)
        return np.maximum(cov, self.minv)

    def _kld(self, cov):
        return 0.5 * float(np.sum(cov / self.cov0
                                  + np.log(self.cov0 / cov))
                           - len(cov))

    def _criterion(self, cov):
        if self.solver == self.MAX:
            temp = self.m2 - 2 * self.m1 * self.mean0 \
                + self.g * self.mean0 ** 2
            return -0.5 * float(np.sum(temp / cov
                                       + self.g * np.log(cov)))
        return float(np.sum(self.grad0 * cov))

    def evaluate(self, lam):
        cov = self.solve(lam)
        kld = self._kld(cov)
        if self.eval_kld:
            return kld
        f_change = self._criterion(cov) - self._criterion(self.cov0)
        return self.k_ratio * kld - f_change


# ------------------------------------------------------------ the step

def _criterion_mix_gammas(stats, mode):
    if mode == "mmi":
        return (stats.buffers[ML_BUF].mix_gamma
                - stats.buffers[MMI_BUF].mix_gamma)
    return stats.buffers[MPE_NUM_BUF].mix_gamma


def _criterion_gauss(stats, mode, G):
    if mode == "mmi":
        num, den = stats.buffers[ML_BUF], stats.buffers[MMI_BUF]
        return (num.gamma - den.gamma)[:G], \
            (num.mean_acc - den.mean_acc)[:G], \
            (num.sec_acc - den.sec_acc)[:G], \
            (num.aux_gamma + den.aux_gamma)[:G]
    num = stats.buffers[MPE_NUM_BUF]
    return num.gamma[:G], num.mean_acc[:G], num.sec_acc[:G], \
        num.aux_gamma[:G]


def kld_constrained_step(model: HmmModel, stats: HmmStats, mode: str,
                         weight_kld_limit: float = 0.1,
                         mean_kld_limit: float = 0.1,
                         cov_kld_limit: float = 0.1,
                         min_var: float = 0.09,
                         ckratio: float = 0.0,
                         mixture_ratio: float | None = None,
                         cov_ratio: float | None = None,
                         info: int = 0) -> HmmModel:
    """Full --kldcs iteration: mixtures then means/covariances."""
    G, D = model.means.shape
    mix_ratio_base = mixture_ratio if mixture_ratio is not None \
        else ckratio
    cov_ratio_base = cov_ratio if cov_ratio is not None else ckratio
    mean_ratio = ckratio

    mix_gam = _criterion_mix_gammas(stats, mode)
    if mode == "mmi":
        gauss_aux = (stats.buffers[ML_BUF].aux_gamma
                     + stats.buffers[MMI_BUF].aux_gamma)
    else:
        gauss_aux = stats.buffers[MPE_NUM_BUF].aux_gamma

    # ---- mixtures (kld_constrained_mixture_update)
    new_mixtures = []
    avg_max_lambda = 1.0
    n_max = 0
    gaussian_weights = np.zeros(G)
    for s, (idx, orig_w) in enumerate(model.mixtures):
        k = len(idx)
        orig = np.asarray(orig_w, dtype=np.float64)
        gam = mix_gam[s, :k].astype(np.float64)
        abs_gam = gauss_aux[np.asarray(idx, dtype=np.int64)]
        gaussian_weights[np.asarray(idx, dtype=np.int64)] += orig

        mix_ratio = mix_ratio_base * k
        solver = CriticalMixtureSolver(orig, gam, abs_gam, mix_ratio)
        lam = 0.0
        if solver.evaluate(0.0) > weight_kld_limit:
            lam = search_lambda(solver.evaluate, avg_max_lambda,
                                weight_kld_limit)
        new_w = solver.solve_weights(lam)
        ok = new_w is not None
        if ok:
            d_obj = solver.objective(new_w) - solver.objective(orig)
            ok = (d_obj >= 0
                  and solver.evaluate(lam) <= weight_kld_limit + 1e-9)
        if ok:
            avg_max_lambda = (avg_max_lambda * n_max + lam) / (n_max + 1)
            n_max += 1
            if mix_ratio > 0:
                solver.eval_kld = False
                if solver.evaluate(lam) > 0:
                    lam = search_lambda(solver.evaluate, max(lam, 1e-10),
                                        0.0)
                    w2 = solver.solve_weights(lam)
                    if w2 is not None:
                        new_w = w2
                solver.eval_kld = True
            new_mixtures.append((idx.copy(), new_w))
        else:
            # reference skips the mixture when the critical update
            # fails (clsstep.cc:2648-2652)
            new_mixtures.append((idx.copy(), orig.copy()))

    # ---- means / covariances (kld_constrained_mean_covariance_update)
    d_gamma, d_m1, d_m2, _aux = _criterion_gauss(stats, mode, G)
    mean = np.asarray(model.means, dtype=np.float64)
    cov = np.asarray(model.covars, dtype=np.float64)
    new_mean = mean.copy()
    new_cov = cov.copy()
    avg_mean_lambda = 1.0
    n_mean = 0
    avg_cov_max_lambda = 1.0
    n_cov_max = 0
    avg_cov_lin_lambda = 1.0
    n_cov_lin = 0

    for i in range(G):
        if d_gamma[i] == 0:
            continue

        # mean
        min_lambda = max(-d_gamma[i], 0.0)
        ms = MeanSolver(mean[i], cov[i], d_gamma[i], d_m1[i], mean_ratio)
        lam = min_lambda
        if ms.evaluate(min_lambda) >= mean_kld_limit:
            lam = search_lambda(ms.evaluate,
                                max(avg_mean_lambda, min_lambda),
                                mean_kld_limit)
            lam = max(lam, min_lambda)
            avg_mean_lambda = (avg_mean_lambda * n_mean + lam) \
                / (n_mean + 1)
            n_mean += 1
        target_mean = ms.solve(lam)
        if mean_ratio > 0:
            ms.eval_kld = False
            if ms.evaluate(lam) > 0:
                lam = search_lambda(ms.evaluate, max(lam, 1e-10), 0.0)
                target_mean = ms.solve(lam)
            ms.eval_kld = True
        new_mean[i] = target_mean

        # covariance
        cs = CovSolver(mean[i], cov[i], d_gamma[i], d_m1[i], d_m2[i],
                       min_var, cov_ratio_base)
        # minimum lambda keeping the critical solve real
        # (clsstep.cc:2913-2930)
        c_stat = d_m2[i] - 2 * d_m1[i] * mean[i] \
            + d_gamma[i] * mean[i] ** 2
        disc = (4 * c_stat / cov[i] - 2 * d_gamma[i]) ** 2 \
            - 4 * d_gamma[i] ** 2
        lim2 = np.where(
            disc > 0,
            (2 * d_gamma[i] - 4 * c_stat / cov[i]
             + np.sqrt(np.maximum(disc, 0))) / 2, 0.0)
        min_lambda = max(float(np.max(lim2)), 0.0)

        max_update = True
        lam = min_lambda
        if cs.evaluate(min_lambda) > cov_kld_limit:
            lam = search_lambda(cs.evaluate,
                                max(min_lambda, avg_cov_max_lambda),
                                cov_kld_limit)
            lam = max(lam, min_lambda)
        target_cov = cs.solve(lam)
        # critical point must be a maximum of the Lagrangian
        # (clsstep.cc:2940-2957)
        f_2nd = -(c_stat - d_gamma[i] * target_cov / 2.0) \
            / target_cov ** 3
        k_2nd = 1.0 / (2 * target_cov ** 2)
        if np.any(f_2nd - lam * k_2nd >= 0):
            max_update = False
        else:
            avg_cov_max_lambda = (avg_cov_max_lambda * n_cov_max + lam) \
                / (n_cov_max + 1)
            n_cov_max += 1

        if not max_update:
            cs.solver = CovSolver.LINEAR
            lam = search_lambda(cs.evaluate, avg_cov_lin_lambda,
                                cov_kld_limit)
            avg_cov_lin_lambda = (avg_cov_lin_lambda * n_cov_lin + lam) \
                / (n_cov_lin + 1)
            n_cov_lin += 1
            target_cov = cs.solve(lam)

        if cov_ratio_base > 0:
            cs.eval_kld = False
            if cs.evaluate(lam) > 0:
                lam = search_lambda(cs.evaluate, max(lam, 1e-10), 0.0)
                target_cov = cs.solve(lam)
            cs.eval_kld = True
        new_cov[i] = target_cov

    return HmmModel(
        dim=model.dim, cov_type=model.cov_type, means=new_mean,
        covars=new_cov, full_covars=dict(model.full_covars),
        gauss_kind=list(model.gauss_kind), mixtures=new_mixtures,
        phones=list(model.phones),
        transitions={k: list(v) for k, v in model.transitions.items()},
        durations=model.durations)
