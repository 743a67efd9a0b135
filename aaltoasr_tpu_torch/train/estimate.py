"""M-step parameter estimation — the `estimate` tool's core
(`aku/estimate.cc:108-430`, `aku/Distributions.cc:502-716, 2263-2350`,
`aku/HmmSet.cc:782-815`).

Host copy of `aaltoasr_tpu/train/estimate.py`.

ML updates (this module; EBW/MMI/MPE live in train.ebw):
* Gaussian: mean = m1/gamma, cov = m2/gamma - mean^2, floored at
  ``minvar`` (default 0.1, `aku/estimate.cc:131`); Gaussians without
  statistics keep their old parameters.
* Mixture: w_k = gamma_k / sum(gamma) (`aku/Distributions.cc:2277-2283`),
  then components under ``mixture_minweight`` are pruned and weights
  renormalized.
* Transitions: prob = occ / sum(occ per state), floored at .001; states
  with no data keep old probs (`aku/HmmSet.cc:782-815`).

All updates are vectorized NumPy on host — the M-step touches [G, D]
arrays once, no device round trip needed (the E-step already reduced).
"""

from __future__ import annotations

import numpy as np

from aaltoasr_tpu_torch.formats.model_io import HmmModel
from aaltoasr_tpu_torch.models.hmm import TransitionTable
from aaltoasr_tpu_torch.train.accumulators import HmmStats, ML_BUF


def estimate_ml(model: HmmModel, table: TransitionTable, stats: HmmStats,
                minvar: float = 0.1, min_gamma: float = 0.0,
                mixture_minweight: float = 0.0,
                update_means: bool = True, update_covars: bool = True,
                update_mixtures: bool = True,
                update_transitions: bool = True) -> HmmModel:
    """Return a new model with ML-updated parameters."""
    buf = stats.buffers[ML_BUF]
    G = model.num_gaussians
    gamma = buf.gamma[:G]
    has_data = gamma > max(min_gamma, 0.0)

    means = model.means.copy()
    covars = model.covars.copy()
    safe_gamma = np.where(has_data, gamma, 1.0)
    new_mean = buf.mean_acc[:G] / safe_gamma[:, None]
    new_cov = buf.sec_acc[:G] / safe_gamma[:, None] - new_mean ** 2
    new_cov = np.maximum(new_cov, minvar)
    if update_means:
        means = np.where(has_data[:, None], new_mean, means)
    if update_covars:
        covars = np.where(has_data[:, None], new_cov, covars)

    full_covars = dict(model.full_covars)
    # full-covariance M-step (PDF_ML_FULL_STATS accumulators;
    # Gaussian::estimate_parameters ML + set_covariance SPD check):
    # only Gaussians that already carry a full covariance update it
    if update_covars and buf.full_acc is not None and full_covars:
        for g in list(full_covars):
            if g >= G or not has_data[g]:
                continue
            mu = new_mean[g]
            C = buf.full_acc[g] / safe_gamma[g] - np.outer(mu, mu)
            np.fill_diagonal(C, np.maximum(np.diag(C), minvar))
            if np.linalg.eigvalsh(C).min() > 0:
                full_covars[g] = C
            # else: keep the previous covariance (invalid-parameters
            # branch, Distributions.cc:1571-1578)

    # subspace-constrained M-step: re-optimize coefficients against the
    # accumulated sample mean/covariance (PrecisionConstrainedGaussian /
    # SubspaceConstrainedGaussian::set_parameters ->
    # Subspaces::optimize_coefficients)
    pcgmm_params = dict(model.pcgmm_params)
    scgmm_params = dict(model.scgmm_params)
    if buf.full_acc is not None and (pcgmm_params or scgmm_params):
        for g, (ssid, tm, lam) in list(pcgmm_params.items()):
            if g >= G or not has_data[g]:
                continue
            ps = model.precision_subspaces[ssid]
            mu = new_mean[g]
            C = buf.full_acc[g] / safe_gamma[g] - np.outer(mu, mu)
            if np.linalg.eigvalsh(C).min() <= 0:
                continue        # degenerate stats: keep old parameters
            np.fill_diagonal(C, np.maximum(np.diag(C), minvar))
            lam2 = ps.optimize_coefficients(C, lam0=lam)
            P = ps.compute_precision(lam2)
            pcgmm_params[g] = (ssid, P @ mu, lam2)
            full_covars[g] = np.linalg.inv(P)
            means[g] = mu
            covars[g] = np.diag(full_covars[g])
        for g, (ssid, lam) in list(scgmm_params.items()):
            if g >= G or not has_data[g]:
                continue
            es = model.exponential_subspaces[ssid]
            mu = new_mean[g]
            C = buf.full_acc[g] / safe_gamma[g] - np.outer(mu, mu)
            if np.linalg.eigvalsh(C).min() <= 0:
                continue        # degenerate stats: keep old parameters
            np.fill_diagonal(C, np.maximum(np.diag(C), minvar))
            lam2 = es.optimize_coefficients(mu, C, lam0=lam)
            scgmm_params[g] = (ssid, lam2)
            P = es.compute_precision(lam2)
            full_covars[g] = np.linalg.inv(P)
            means[g] = es.compute_mu(lam2)
            covars[g] = np.diag(full_covars[g])

    mixtures = []
    for s, (idx, w) in enumerate(model.mixtures):
        k = len(idx)
        g = buf.mix_gamma[s, :k]
        tot = g.sum()
        if update_mixtures and tot > 0:
            w_new = g / tot
            if mixture_minweight > 0:
                keep = w_new >= mixture_minweight
                if keep.any():
                    idx = idx[keep]
                    w_new = w_new[keep]
                    w_new = w_new / w_new.sum()
            mixtures.append((idx.copy(), w_new))
        else:
            mixtures.append((idx.copy(), w.copy()))

    transitions = {k: list(v) for k, v in model.transitions.items()}
    if update_transitions and stats.trans_acc is not None:
        for s in range(model.num_states):
            first = int(table.state_first[s])
            count = int(table.state_count[s])
            occ = stats.trans_acc[first:first + count]
            tot = occ.sum()
            if tot > 0:
                probs = np.maximum(occ / tot, 0.001)
                transitions[s] = [
                    (int(table.offset[first + t]), float(probs[t]))
                    for t in range(count)]

    return HmmModel(
        dim=model.dim, cov_type=model.cov_type,
        means=means, covars=covars,
        full_covars=full_covars,
        gauss_kind=list(model.gauss_kind),
        mixtures=mixtures, phones=list(model.phones),
        transitions=transitions, durations=model.durations,
        precision_subspaces=dict(model.precision_subspaces),
        exponential_subspaces=dict(model.exponential_subspaces),
        pcgmm_params=pcgmm_params, scgmm_params=scgmm_params)
