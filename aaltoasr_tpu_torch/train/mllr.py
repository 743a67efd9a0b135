"""CMLLR (fMLLR) adaptation: statistics on the device, row-iteration solve.

Counterpart of `aaltoasr_tpu/train/mllr.py` (reference:
`aku/MllrTrainer.{hh,cc}`).  Per regression class the sufficient
statistics are (MllrTrainer.cc:148-161)::

    beta   = sum_t,g gamma_tg
    k_i    = sum_t,g gamma_tg * mu_gi / sigma_gi^2 * xi_t
    G_i    = sum_t,g gamma_tg / sigma_gi^2 * xi_t xi_t^T

with extended features ``xi = [1; x]``.  Frame x Gaussian posteriors
never materialize: the class/dimension weights fold into two products
over the E-step's responsibilities (R [T, P*K]), ``Wt = R @ M[g]`` and
``Vt = R @ M2[g]`` with the per-(class, dimension) precision tables M,
M2 [Gp, C*D]; k is ``Vt^T xi`` and G one product ``Wt^T [xi xi^T]``
over the per-frame outer products ([C*D, (D+1)^2], not an einsum that
could materialize [T, C*D, D+1, D+1]).  The products run in IEEE float32
whatever the caller's TF32 setting (the reference asks for HIGHEST).
beta is a segment sum (`index_add_`, atomics on the GPU: its order, and
so its last bits, vary between runs).  The solve (Gales' row iteration
with the cofactor alpha quadratic, MllrTrainer.cc:166-253; 20*dim
rounds) and the per-speaker merge are host float64 copies.

`apply_model_cmllr` folds per-class transforms into the Gaussian pool
(host numpy).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F_

from aaltoasr_tpu_torch.device import ieee_float32
from aaltoasr_tpu_torch.formats.model_io import HmmModel
from aaltoasr_tpu_torch.ops.logsemiring import logsumexp
from aaltoasr_tpu_torch.train import estep


def _class_tables(gauss_class, num_classes: int, means, covars):
    """(one-hot [Gp, C], M [Gp, C*D], M2 [Gp, C*D]):
    M[g, c*D + i] = 1[class g == c] * prec[g, i], M2 the same times
    the mean."""
    prec = torch.where(covars > 0, 1.0 / covars, torch.zeros((),
                       device=covars.device))
    onehot = F_.one_hot(gauss_class, num_classes).float()
    Gp, D = prec.shape
    C = num_classes
    M = (onehot[:, :, None] * prec[:, None, :]).reshape(Gp, C * D)
    M2 = (onehot[:, :, None] * (means * prec)[:, None, :]).reshape(Gp, C * D)
    return onehot, M, M2


def _k_and_G(Wt, Vt, x, C: int):
    """k [C, D, D+1] and G [C, D, D+1, D+1] from the per-frame class
    weights Wt, Vt [T, C*D] and the features x [T, D]."""
    T, D = x.shape
    xi = torch.cat([torch.ones((T, 1), dtype=x.dtype, device=x.device), x],
                   dim=1)                                   # [T, D+1]
    k = (Vt.T @ xi).reshape(C, D, D + 1)
    outer = (xi[:, :, None] * xi[:, None, :]).reshape(T, -1)
    G = (Wt.T @ outer).reshape(C, D, D + 1, D + 1)
    return k, G


def cmllr_stats(scorer, features, graph, n_frames, gauss_class,
                num_classes: int, means, covars):
    """Device CMLLR statistics for one utterance.

    features [T, D]; graph: one utterance's tables stacked by
    `estep.stack_graphs` ([1, ...]; a shift-compiled graph runs the
    shift-compiled forward-backward, as in `estep.chain_stats`, another
    float32 order of the same sums); gauss_class: [Gp] regression class
    per Gaussian (int64); means/covars: [Gp, D] model parameters (padded
    like the scorer).  Returns dict(beta [C], k [C, D, D+1],
    G [C, D, D+1, D+1], ll [])."""
    x = features.float()
    T, D = x.shape
    C = num_classes
    n = torch.full((1,), int(n_frames), dtype=torch.int64, device=x.device)
    with ieee_float32():
        gll = scorer.gaussian_log_likelihoods(x[None])   # [1, T, Gp]
        cidx, clogw, gll_pk, state_obs, obs_pos = estep.chain_observations(
            scorer, gll, graph)
        fb = (estep.masked_forward_backward_shift if "sh_logp" in graph
              else estep.masked_forward_backward)
        gamma, _, total = fb(
            obs_pos, {k: v for k, v in graph.items() if k != "final_slot"},
            n, 1, with_transitions=False)
        P, K = cidx.shape[1:]
        log_resp = clogw[:, None] + gll_pk - state_obs[..., None]
        R = gamma[..., None] * torch.exp(torch.clamp(log_resp, min=-80.0))
        R_flat = R.reshape(T, P * K)                       # [T, PK]
        g_flat = cidx.reshape(-1)                          # [PK]
        onehot, M, M2 = _class_tables(gauss_class, C, means, covars)
        Wt = R_flat @ M[g_flat]                            # [T, C*D]
        Vt = R_flat @ M2[g_flat]
        k, G = _k_and_G(Wt, Vt, x, C)
        # beta[c]: the occupancy of the Gaussians of class c
        occ_g = torch.zeros(M.shape[0], device=x.device).index_add_(
            0, g_flat, R_flat.sum(0))
        beta = (onehot * occ_g[:, None]).sum(0)
    return {"beta": beta, "k": k, "G": G, "ll": total[0]}


def cmllr_stats_aligned(scorer, features, frame_pdfs, gauss_class,
                        num_classes: int, means, covars):
    """CMLLR statistics under a FIXED per-frame state segmentation
    (the reference mllr tool's PhnReader path, `aku/mllr.cc:126-145`:
    per-frame probability 1 on the aligned pdf, Gaussian-level
    responsibilities within its mixture — MllrTrainer::collect_data).
    frame_pdfs: [T] int64 on the device."""
    x = features.float()
    T, D = x.shape
    C = num_classes
    with ieee_float32():
        gll = scorer.gaussian_log_likelihoods(x)          # [T, Gp]
        cidx = scorer.comp_idx[frame_pdfs]                 # [T, K]
        clogw = scorer.comp_logw[frame_pdfs]
        gl = torch.gather(gll, 1, cidx)
        # the reference's within-mixture responsibilities use RAW
        # Gaussian likelihoods, NOT weighted by the mixture coefficients
        # (MllrTrainer::collect_data: probs[g] = compute_likelihood;
        # probs[g] = prior*probs[g]/probsum) — padding components carry
        # clogw = LOG_ZERO, so mask on that rather than folding it in
        gl = torch.where(clogw > -1e30, gl, torch.full((), -torch.inf,
                                                         device=x.device))
        sll = logsumexp(gl, dim=-1)
        R = torch.exp(torch.clamp(gl - sll[:, None], min=-80.0))   # [T, K]
        onehot, M, M2 = _class_tables(gauss_class, C, means, covars)
        Wt = torch.einsum("tk,tkm->tm", R, M[cidx])
        Vt = torch.einsum("tk,tkm->tm", R, M2[cidx])
        k, G = _k_and_G(Wt, Vt, x, C)
        occ_g = torch.zeros(M.shape[0], device=x.device).index_add_(
            0, cidx.reshape(-1), R.reshape(-1))
        beta = (onehot * occ_g[:, None]).sum(0)
        ll = torch.clamp(sll, min=float(np.log(1e-50))).sum()
    return {"beta": beta, "k": k, "G": G, "ll": ll}


def solve_cmllr(G: np.ndarray, k: np.ndarray, beta: float,
                rounds_per_dim: int = 20) -> np.ndarray:
    """Row-iteration CMLLR solve -> W [D, D+1] with column 0 = bias.

    Exact port of the reference algorithm (MllrTrainer.cc:166-253):
    alpha from ``c2 a^2 + c1 a - beta = 0`` picking the higher-objective
    root, W_row = G_i^{-1} (alpha * p + k_i).
    """
    D = k.shape[0]
    W = np.zeros((D, D + 1))
    W[:, 1:] = np.eye(D)
    inv_G = np.stack([np.linalg.inv(G[i]) for i in range(D)])

    for rnd in range(rounds_per_dim * D):
        row = rnd % D
        A = W[:, 1:]
        detA = np.linalg.det(A)
        cof = np.linalg.inv(A).T * detA       # cofactor matrix
        p = np.zeros(D + 1)
        p[1:] = cof[row]
        c2 = p @ inv_G[row] @ p
        c1 = p @ inv_G[row] @ k[row]
        disc = np.sqrt(c1 * c1 + 4 * c2 * beta)
        a1 = (-c1 + disc) / (2 * c2)
        a2 = (-c1 - disc) / (2 * c2)
        m1 = beta * np.log(np.abs(a1 * c2 + c1)) - (c2 / 2) * a1 * a1
        m2 = beta * np.log(np.abs(a2 * c2 + c1)) - (c2 / 2) * a2 * a2
        alpha = a1 if m1 > m2 else a2
        W[row] = inv_G[row] @ (alpha * p + k[row])
    return W


class CmllrEstimator:
    """Accumulate CMLLR statistics over utterances, solve per class.

    Each utterance's statistics come back in one fetch and merge on the
    host in float64, as the reference's do."""

    def __init__(self, scorer, table, gauss_class: np.ndarray,
                 num_classes: int, means, covars):
        self.scorer = scorer
        self.table = table
        dev = scorer.device
        self.gauss_class = torch.as_tensor(np.asarray(gauss_class),
                                           dtype=torch.int64, device=dev)
        self.num_classes = num_classes
        Gp = scorer.score_matrix.shape[1]
        D = means.shape[1]
        mp = np.zeros((Gp, D), np.float32)
        cp = np.ones((Gp, D), np.float32)
        mp[:means.shape[0]] = means
        cp[:covars.shape[0]] = covars
        self.means = torch.as_tensor(mp, device=dev)
        self.covars = torch.as_tensor(cp, device=dev)
        self._acc = None

    def _merge(self, out) -> None:
        keys = list(out)
        flat = torch.cat([out[k].reshape(-1).double() for k in keys]).cpu()
        parts = torch.split(flat, [out[k].numel() for k in keys])
        out = {k: p.numpy().reshape(tuple(out[k].shape))
               for k, p in zip(keys, parts)}
        if self._acc is None:
            self._acc = out
        else:
            for kk in ("beta", "k", "G"):
                self._acc[kk] += out[kk]

    def accumulate(self, features, graph: dict, n_frames) -> None:
        """One utterance: features [T, D] (array or tensor), its padded
        chain or network tables as numpy (`pad_chain`)."""
        dev = self.scorer.device
        feats = torch.as_tensor(features, dtype=torch.float32, device=dev)
        self._merge(cmllr_stats(
            self.scorer, feats, estep.stack_graphs([graph], dev), n_frames,
            self.gauss_class, self.num_classes, self.means, self.covars))

    def accumulate_aligned(self, features, frame_pdfs) -> None:
        """Fixed-segmentation accumulation (mllr.cc PhnReader path)."""
        dev = self.scorer.device
        T = min(features.shape[0], len(frame_pdfs))
        feats = torch.as_tensor(features[:T], dtype=torch.float32, device=dev)
        pdfs = torch.as_tensor(np.asarray(frame_pdfs[:T], np.int64),
                               device=dev)
        self._merge(cmllr_stats_aligned(
            self.scorer, feats, pdfs, self.gauss_class, self.num_classes,
            self.means, self.covars))

    def transforms(self, min_frames: float = 1000.0):
        """Per-class W [D, D+1] (identity where beta < min_frames;
        MllrTrainer.cc:63-96 min_frames gate)."""
        D = self.means.shape[1]
        out = []
        for c in range(self.num_classes):
            if self._acc is None or self._acc["beta"][c] < min_frames:
                W = np.zeros((D, D + 1))
                W[:, 1:] = np.eye(D)
            else:
                W = solve_cmllr(self._acc["G"][c], self._acc["k"][c],
                                float(self._acc["beta"][c]))
            out.append(W)
        return out


# ---------------------------------------------------------------------------
# model-space CMLLR (ModelModules ConstrainedMllr)
# ---------------------------------------------------------------------------

def apply_model_cmllr(model, transforms: list, gauss_class) -> HmmModel:
    """Fold per-class CMLLR transforms into the Gaussian pool
    (`aku/ModelModules.hh:72-210` ConstrainedMllr: Gaussians evaluate
    their class's transformed feature A_c x + b_c with a +log|det A_c|
    constant).

    Evaluating a diagonal Gaussian on A x + b is exactly a
    full-covariance Gaussian in x — precision A' diag(p) A, mean
    A^-1 (mu - b) — and the scorer's constant 0.5*log det(precision)
    reproduces log|det A| + 0.5*sum log p.  So the adaptation is a pure
    model rewrite feeding the exponential-form matmul.

    transforms: per class, [D, D+1] rows [b | A] (the CMLLR W).
    gauss_class: [G] class index per Gaussian.
    """
    G, D = model.means.shape
    prec = model.precisions()
    means = np.zeros_like(model.means)
    full = {}
    kind = []
    Ainvs = []
    for W in transforms:
        W = np.asarray(W, dtype=np.float64)
        Ainvs.append((np.linalg.inv(W[:, 1:]), W[:, 0]))
    for g in range(G):
        Ainv, b = Ainvs[int(gauss_class[g])]
        means[g] = Ainv @ (model.means[g] - b)
        if g in model.full_covars:
            cov = np.asarray(model.full_covars[g], dtype=np.float64)
        else:
            with np.errstate(divide="ignore"):
                cov = np.diag(np.where(prec[g] > 0, 1.0 / prec[g], 0.0))
        full[g] = Ainv @ cov @ Ainv.T
        kind.append("full")
    return HmmModel(
        dim=D, cov_type="variable", means=means, covars=model.covars,
        mixtures=model.mixtures, phones=model.phones,
        transitions=model.transitions, durations=model.durations,
        full_covars=full, gauss_kind=kind)
