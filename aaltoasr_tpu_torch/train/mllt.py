"""MLLT / semi-tied covariance transform estimation.

Counterpart of `aaltoasr_tpu/train/mllt.py`: `solve_mllt`, `apply_mllt`
and `compose_into_config` are host copies; `full_second_moment_stats`
is the device pass, batched like `train/estep.py`.

Reference: `aku/HmmSet.hh:407` estimate_mllt, applied in train.pl from
iteration 15 every 2 iterations (train.pl:86-176), with the transform
living in the feature config's lin_transform module.

Algorithm (Gales' semi-tied covariance, the same update the reference
uses): given per-Gaussian occupancies and FULL second-moment statistics,
iterate row-wise

    A_r <- c_r G_r^{-1} * sqrt(beta / (c_r G_r^{-1} c_r^T))

where G_r = sum_g gamma_g * Sigma_g / (A Sigma_g A^T)_rr and c_r is the
cofactor row of A.
"""

from __future__ import annotations

import numpy as np
import torch

from aaltoasr_tpu_torch.ops.logsemiring import logsumexp
from aaltoasr_tpu_torch.train import estep


def full_second_moment_stats(scorer, features, graph, n_frames,
                             num_gaussians: int):
    """Device pass over a batch (features [B, T, D], stacked graph
    tables, n_frames [B]): per utterance (gamma [B, Gp], m1 [B, Gp, D],
    m2_full [B, Gp, D, D], ll [B]).  IEEE float32 products (TF32 off)."""
    pdf = graph["pdf"]
    B, T, D = features.shape
    K = scorer.comp_idx.shape[1]
    P = pdf.shape[1]
    Gp = scorer.score_matrix.shape[1]
    x = features.float()

    gll = scorer.gaussian_log_likelihoods(x)                   # [B, T, Gp]
    sll = logsumexp(gll[..., scorer.comp_idx] + scorer.comp_logw, dim=-1)
    state = estep._take_t(sll, pdf)                             # [B, T, P]
    obs_pos = state
    if "obs_const" in graph:
        obs_pos = obs_pos + graph["obs_const"][:, None, :]
    gamma, _, total = estep.masked_forward_backward(
        obs_pos, {k: v for k, v in graph.items() if k != "final_slot"},
        n_frames, 1, with_transitions=False)

    cidx = scorer.comp_idx[pdf]                                 # [B, P, K]
    clogw = scorer.comp_logw[pdf]
    log_resp = clogw[:, None] + estep._take_t(gll, cidx) - state[..., None]
    R = gamma[..., None] * torch.exp(torch.clamp(log_resp, min=-80.0))
    R_flat = R.reshape(B, T, P * K)
    g_flat = cidx.reshape(B, 1, P * K).expand(B, T, P * K)
    gamma_tg = torch.zeros((B, T, Gp), dtype=torch.float32,
                           device=x.device).scatter_add_(2, g_flat, R_flat)
    g = gamma_tg.sum(1)
    gt = gamma_tg.transpose(1, 2)                               # [B, Gp, T]
    m1 = torch.bmm(gt, x)                                       # [B, Gp, D]
    outer = (x[..., :, None] * x[..., None, :]).reshape(B, T, D * D)
    m2 = torch.bmm(gt, outer).reshape(B, Gp, D, D)
    return {"gamma": g, "m1": m1, "m2_full": m2, "ll": total}


def solve_mllt(gamma: np.ndarray, m1: np.ndarray, m2_full: np.ndarray,
               iters: int = 10, min_gamma: float = 1e-2) -> np.ndarray:
    """Estimate the [D, D] MLLT matrix from full per-Gaussian stats."""
    G, D = m1.shape
    use = gamma > min_gamma
    gam = gamma[use]
    mu = m1[use] / gam[:, None]
    sigma = (m2_full[use] / gam[:, None, None]
             - mu[:, :, None] * mu[:, None, :])
    # regularize
    sigma = sigma + 1e-6 * np.eye(D)
    beta = gam.sum()

    A = np.eye(D)
    for _ in range(iters):
        # per-Gaussian transformed diagonal variances
        ASA = np.einsum("ij,gjk,lk->gil", A, sigma, A)
        diag = np.maximum(np.einsum("gii->gi", ASA), 1e-8)  # [Gu, D]
        cof = np.linalg.inv(A).T * np.linalg.det(A)
        for r in range(D):
            G_r = np.einsum("g,gij->ij", gam / diag[:, r], sigma)
            G_inv = np.linalg.inv(G_r)
            c = cof[r]
            denom = c @ G_inv @ c
            if denom <= 0:
                continue
            A[r] = c @ G_inv * np.sqrt(beta / denom)
            # cofactors and variances are refreshed on the next pass
        # normalize determinant sign
        if np.linalg.det(A) < 0:
            A[0] = -A[0]
    return A


def apply_mllt(model, A: np.ndarray):
    """Transform model parameters into MLLT space: mu' = A mu,
    sigma'_diag = diag(A Sigma_diag A^T) using the model's (diagonal)
    covariances as Sigma."""
    new_means = model.means @ A.T
    new_covars = np.einsum("ij,gj,kj->gik", A, model.covars, A)
    new_covars = np.einsum("gii->gi", new_covars)
    out = type(model)(
        dim=model.dim, cov_type=model.cov_type,
        means=new_means, covars=np.maximum(new_covars, 1e-6),
        full_covars=dict(model.full_covars),
        gauss_kind=list(model.gauss_kind),
        mixtures=[(i.copy(), w.copy()) for i, w in model.mixtures],
        phones=list(model.phones),
        transitions={k: list(v) for k, v in model.transitions.items()},
        durations=model.durations)
    return out


def compose_into_config(config, A: np.ndarray,
                        module_name: str = "mllt") -> None:
    """Fold A into the config's lin_transform module: A_new = A @ A_old
    (MllrTrainer.cc:112-140 composition semantics)."""
    spec = config.by_name[module_name]
    D = A.shape[0]
    old = spec.config.get_float_vec("matrix")
    old_A = (np.asarray(old).reshape(D, -1) if old
             else np.eye(D))
    old_b = np.asarray(
        spec.config.get_float_vec("bias", [0.0] * D))
    new_A = A @ old_A
    new_b = A @ old_b
    spec.config.set("matrix", [float(x) for x in new_A.reshape(-1)])
    spec.config.set("bias", [float(x) for x in new_b])
