"""GMM state likelihoods as matmuls: the plain scoring path.

Counterpart of `aaltoasr_tpu/ops/gmm.py`.  Diagonal models:

    log N_g(x) = -0.5 * sum_d (x_d - mu_gd)^2 * p_gd + C_g
               = [x^2, x] @ [-0.5*p_g ; mu_g*p_g] + (C_g - 0.5*sum mu^2 p)

with ``C_g = log sqrt(prod p_g)``, the reference's unnormalized constant
(`aku/Distributions.cc:1273-1287`).  Full-covariance, ``variable`` and
subspace (PCGMM/SCGMM) models score in the exponential form over
``phi(x) = [vec(x x^T), x]``, the subspace terms factored through their
shared basis; cluster-gated evaluation (`phone_probs -C`) scores exactly
inside the top-ranked clusters and the center elsewhere.  Mixture
scores are a gather plus a masked logsumexp over padded component
tables, and the LNA normalization (`aku/PhoneProbsToolbox.cc:93-105`) is
``max(ll - logsumexp(ll), log(1e-50))``.  The diagonal and gated
products run in IEEE float32 (TF32 stays off).  The full-covariance and
subspace products run in float64, their tables built in float64: phi(x)
squares features of magnitude ~10^2, and on large model-space CMLLR
transforms (precision entries to ~390) the terms of size |x|^2 |P|
cancel down to the log-likelihood, which float32 rounds several LNA
steps off the exact codes (`tests/test_torch_fullcov_codes.py`).  The
JAX package forms the same product in float32.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from aaltoasr_tpu_torch.device import ieee_float32, resolve_device
from aaltoasr_tpu_torch.formats.model_io import HmmModel
from aaltoasr_tpu_torch.ops.logsemiring import (
    LOG_ZERO, SAFE_LOG_FLOOR, logsumexp)
from aaltoasr_tpu_torch.utils import profiling


_PAD_GAUSSIANS = 128    # Gaussian-axis padding of the score matrix
_PAD_STATES = 8         # state-axis padding of the component tables


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class GmmScorer:
    """Scoring tables for one acoustic model on one device.

    score_matrix  [2D, Gp]  stacked [-0.5*p ; mu*p]
                  ([D*D + D, Gp] over phi(x), float64, when full_cov)
    score_bias    [Gp]      C_g - 0.5*sum_d mu^2 p (float64 when full_cov)
    comp_idx      [Sp, K]   mixture component Gaussian indices (padded)
    comp_logw     [Sp, K]   log mixture weights (LOG_ZERO padding)
    """

    dim: int
    num_states: int
    num_gaussians: int
    score_matrix: torch.Tensor
    score_bias: torch.Tensor
    comp_idx: torch.Tensor
    comp_logw: torch.Tensor
    full_cov: bool = False
    # factored subspace scoring (PCGMM/SCGMM, ops/subspaces.py): per
    # shared subspace one ([D_phi, B] basis, [B, Gp] coefficients) pair;
    # scores += (phi(x) @ basis) @ coeffs
    sub_basis: tuple = ()
    sub_lambda: tuple = ()
    # cluster gating (PDFPool::compute_likelihoods clustering branch,
    # Distributions.cc:2684-2722): None = dense evaluation
    cluster_of: torch.Tensor | None = None       # [Gp] cluster per Gaussian
    cluster_matrix: torch.Tensor | None = None   # [2D, C] center tables
    cluster_bias: torch.Tensor | None = None     # [C]
    cluster_sizes: torch.Tensor | None = None    # [C]
    min_eval_clusters: int = 0
    min_eval_gauss: int = 0

    @classmethod
    def from_model(cls, model: HmmModel,
                   device: torch.device | str = "cuda") -> "GmmScorer":
        device = resolve_device(device)
        means = model.means
        G, D = means.shape
        Gp = _round_up(G, _PAD_GAUSSIANS)
        has_sub = bool(model.pcgmm_params or model.scgmm_params)
        full_cov = scores_full_cov(model)

        if full_cov:
            # exponential form over phi(x) = [vec(x x^T), x]:
            # logN = C - mu'P mu/2 + (P mu).x - vec(P).vec(xx')/2
            # (FullCovarianceGaussian::compute_log_likelihood,
            # Distributions.cc:1413-1426; diagonal Gaussians embed as
            # diagonal precision matrices so `variable` models score in
            # the same matmul)
            diag_prec = model.precisions()
            A = np.zeros((D * D + D, Gp))
            bias = np.full(Gp, LOG_ZERO)
            for g in range(G):
                if g in model.pcgmm_params:
                    ssid, tm, lam = model.pcgmm_params[g]
                    ps = model.precision_subspaces[ssid]
                    A[D * D:, g] = tm
                    bias[g] = ps.constant(tm, lam)
                    continue
                if g in model.scgmm_params:
                    ssid, lam = model.scgmm_params[g]
                    es = model.exponential_subspaces[ssid]
                    bias[g] = es.constant(lam)
                    continue
                if g in model.full_covars:
                    cov = np.asarray(model.full_covars[g], np.float64)
                    P, C = _spd_precision(cov)
                else:
                    P = np.diag(diag_prec[g])
                    pr = np.prod(diag_prec[g])
                    C = 0.5 * np.log(max(pr, 1e-300)) if pr > 0 else 0.0
                mu = means[g]
                A[:D * D, g] = (-0.5 * P).reshape(-1)
                A[D * D:, g] = P @ mu
                bias[g] = C - 0.5 * mu @ P @ mu
        else:
            prec = model.precisions()
            const = model.gauss_constants()
            A = np.zeros((2 * D, Gp), dtype=np.float32)
            A[:D, :G] = (-0.5 * prec).T
            A[D:, :G] = (means * prec).T
            bias = np.full(Gp, LOG_ZERO, dtype=np.float32)
            bias[:G] = const - 0.5 * np.sum(means * means * prec, axis=1)

        S = len(model.mixtures)
        K = max((len(ix) for ix, _ in model.mixtures), default=1)
        Sp = _round_up(S, _PAD_STATES)
        comp_idx = np.zeros((Sp, K), dtype=np.int64)
        comp_logw = np.full((Sp, K), LOG_ZERO, dtype=np.float32)
        for s, (idx, w) in enumerate(model.mixtures):
            comp_idx[s, :len(idx)] = idx
            with np.errstate(divide="ignore"):
                comp_logw[s, :len(w)] = np.where(
                    w > 0, np.log(np.maximum(w, 1e-300)), LOG_ZERO)

        def dev(a):
            return torch.as_tensor(a, device=device)

        sub_basis, sub_lambda = [], []
        if has_sub:
            from aaltoasr_tpu_torch.ops.subspaces import (
                pcgmm_tables, scgmm_tables)
            for ssid, ps in sorted(model.precision_subspaces.items()):
                params = {g: (tm, lam) for g, (sid, tm, lam)
                          in model.pcgmm_params.items() if sid == ssid}
                t = pcgmm_tables(ps, params, D, Gp)
                sub_basis.append(dev(t["sub_basis"]))
                sub_lambda.append(dev(t["sub_lambda"]))
            for ssid, es in sorted(model.exponential_subspaces.items()):
                params = {g: lam for g, (sid, lam)
                          in model.scgmm_params.items() if sid == ssid}
                t = scgmm_tables(es, params, D, Gp)
                sub_basis.append(dev(t["sub_basis"]))
                sub_lambda.append(dev(t["sub_lambda"]))
        return cls(dim=D, num_states=S, num_gaussians=G,
                   score_matrix=dev(A), score_bias=dev(bias),
                   comp_idx=dev(comp_idx), comp_logw=dev(comp_logw),
                   full_cov=full_cov, sub_basis=tuple(sub_basis),
                   sub_lambda=tuple(sub_lambda))

    @property
    def device(self) -> torch.device:
        return self.score_matrix.device

    def gaussian_log_likelihoods(self, features: torch.Tensor) -> torch.Tensor:
        """[..., T, D] features -> [..., T, Gp] per-Gaussian log-likelihoods."""
        if not self.full_cov:
            x = features.float()
            xx = torch.cat([x * x, x], dim=-1)
            return xx @ self.score_matrix + self.score_bias
        # phi(x) and the products in the tables' type, float64 as
        # `from_model` builds them (module docstring)
        x = features.to(self.score_matrix.dtype)
        outer = (x[..., :, None] * x[..., None, :]).flatten(-2)
        xx = torch.cat([outer, x], dim=-1)
        with ieee_float32():
            out = xx @ self.score_matrix + self.score_bias
            for sb, sl in zip(self.sub_basis, self.sub_lambda):
                # phi(x) through the shared subspace basis, then coefficients
                out = out + (xx @ sb) @ sl
        return out.float()

    def with_clustering(self, model: HmmModel, assign: np.ndarray,
                        num_clusters: int, eval_minc: float = 0.0,
                        eval_ming: float = 0.1) -> "GmmScorer":
        """Attach Gaussian clustering for gated evaluation
        (HmmSet::set_clustering_min_evals, HmmSet.cc:1354-1366).

        Cluster centers merge their members with equal weights
        (PDFPool::read_clustering); non-selected Gaussians score their
        center's likelihood.  The gate reproduces the reference's
        approximation (for parity), it does not save work: padded
        Gaussians belong to cluster 0, and the minimum counts are
        clamped at 1."""
        G, D = model.means.shape
        C = num_clusters
        mu = np.zeros((C, D))
        var = np.ones((C, D))
        sizes = np.zeros(C, dtype=np.int64)
        for c in range(C):
            m = assign == c
            sizes[c] = int(m.sum())
            if sizes[c]:
                mu[c] = model.means[m].mean(axis=0)
                var[c] = ((model.covars[m]
                           + model.means[m] ** 2).mean(axis=0)
                          - mu[c] ** 2)
        with np.errstate(divide="ignore"):
            prec = np.where(var > 0, 1.0 / var, 0.0)
        A = np.zeros((2 * D, C), dtype=np.float32)
        A[:D] = (-0.5 * prec).T
        A[D:] = (mu * prec).T
        prod = np.prod(prec, axis=1)
        const = np.where(prod > 0,
                         0.5 * np.log(np.maximum(prod, 1e-300)), 0.0)
        bias = (const - 0.5 * np.sum(mu * mu * prec, axis=1)
                ).astype(np.float32)
        Gp = int(self.score_matrix.shape[1])
        cl = np.zeros(Gp, dtype=np.int64)
        cl[:G] = assign

        def dev(a):
            return torch.as_tensor(a, device=self.device)

        return dataclasses.replace(
            self, cluster_of=dev(cl), cluster_matrix=dev(A),
            cluster_bias=dev(bias), cluster_sizes=dev(sizes),
            min_eval_clusters=max(int(eval_minc * C), 1),
            min_eval_gauss=max(int(eval_ming * G), 1))

    def gated_gaussian_log_likelihoods(self, features: torch.Tensor):
        """Clustered evaluation: exact likelihoods inside the top-ranked
        clusters, the center likelihood elsewhere
        (Distributions.cc:2695-2722).  Clusters rank by a stable sort of
        their scores (equal scores keep the lower index first, as
        `jnp.argsort` does)."""
        lead = features.shape[:-1]
        x = features.float().reshape(-1, features.shape[-1])
        gll = self.gaussian_log_likelihoods(x)             # [T, Gp]
        xx = torch.cat([x * x, x], dim=-1)
        cll = xx @ self.cluster_matrix + self.cluster_bias  # [T, C]
        C = cll.shape[1]
        order = torch.argsort(-cll, dim=1, stable=True)
        sizes = self.cluster_sizes[order]
        cum_before = torch.cumsum(sizes, dim=1) - sizes
        rank = torch.arange(C, device=cll.device)[None, :]
        sel_sorted = ((rank < self.min_eval_clusters)
                      | (cum_before < self.min_eval_gauss))
        sel = torch.zeros(cll.shape, dtype=torch.bool, device=cll.device)
        sel.scatter_(1, order, sel_sorted)
        mask = sel[:, self.cluster_of]                     # [T, Gp]
        out = torch.where(mask, gll, cll[:, self.cluster_of])
        return out.reshape(lead + (out.shape[-1],))

    def state_log_likelihoods(self, features: torch.Tensor) -> torch.Tensor:
        """[..., T, D] -> [..., T, Sp] mixture (tied-state) log-likelihoods
        (HmmSet::precompute_likelihoods + state_likelihood,
        `aku/HmmSet.cc:485`, `aku/Distributions.cc:2079`)."""
        if self.cluster_of is not None:
            gll = self.gated_gaussian_log_likelihoods(features)
        else:
            gll = self.gaussian_log_likelihoods(features)  # [..., T, Gp]
        comp = gll[..., self.comp_idx]                     # [..., T, Sp, K]
        return logsumexp(comp + self.comp_logw, dim=-1)

    def lna_log_probs(self, features: torch.Tensor) -> torch.Tensor:
        """[..., T, D] -> [..., T, S] LNA-normalized log-probs
        (PPToolbox::generate_to_fd, `aku/PhoneProbsToolbox.cc:93-105`)."""
        with profiling.span("scoring.lna"):
            ll = self.state_log_likelihoods(features)[..., :self.num_states]
            return lna_normalize(ll)


def scores_full_cov(model: HmmModel) -> bool:
    """Whether `GmmScorer.from_model` scores ``model`` in the
    full-covariance form (full or subspace Gaussians), which the fused
    kernel does not take."""
    return bool(model.cov_type == "full_cov" or "full" in model.gauss_kind
                or model.pcgmm_params or model.scgmm_params)


def _spd_precision(cov: np.ndarray):
    """(precision, log sqrt det precision) for an SPD covariance;
    zeros when not SPD (FullCovarianceGaussian::set_covariance,
    Distributions.cc:1560-1580: invalid parameters score constant)."""
    try:
        eig = np.linalg.eigvalsh(cov)
        if eig.min() <= 0:
            raise np.linalg.LinAlgError
        P = np.linalg.inv(cov)
        C = 0.5 * float(np.linalg.slogdet(P)[1])
        return P, C
    except np.linalg.LinAlgError:
        D = cov.shape[0]
        return np.zeros((D, D)), 0.0


def lna_normalize(ll: torch.Tensor) -> torch.Tensor:
    """Divide linear likelihoods by their sum over states, floored at
    safe_log(1e-50): ``max(ll - logsumexp(ll), log(1e-50))``."""
    norm = logsumexp(ll, dim=-1, keepdim=True)
    return torch.clamp(ll - norm, min=SAFE_LOG_FLOOR)


def quantize_lna_u16(log_probs: torch.Tensor) -> torch.Tensor:
    """[T, S] log-probs -> [T, S] 2-byte LNA codes, as int32 in [0, 0xFFFF].

    ``v = int(-1820*lp + 0.5)`` truncating toward zero, 0xFFFF below
    -36.008 (`aku/PhoneProbsToolbox.cc:106-124`).  The host writes them
    big-endian.
    """
    v = (-1820.0 * log_probs + 0.5).to(torch.int32)
    return torch.where(log_probs < -36.008,
                       torch.full_like(v, 0xFFFF), v.clamp(0, 0xFFFF))
