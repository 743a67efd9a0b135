"""Gaussian splitting for mixture growth (`aku/HmmSet.cc:1214-1360`
split_gaussians, `aku/Distributions.cc:717-739` Gaussian::split).

Host copy of `aaltoasr_tpu/train/split.py`.

Splitting visits Gaussians in descending ML occupancy.  A split is
allowed when every mixture using the Gaussian stays under ``maxg``
components, the Gaussian's occupancy reaches ``minocc``, and (with a
``numgauss`` target) the mixture's occupancy^alpha / (size+1) stays above
a per-mixture minimum found by a 30-step binary search over the target
count (HmmSet.cc:1247-1298).  The split perturbs the mean by
+-perturbation * sqrt(cov) (cholesky of a diagonal covariance) and halves
the mixture weight.
"""

from __future__ import annotations

import numpy as np

from aaltoasr_tpu_torch.formats.model_io import HmmModel
from aaltoasr_tpu_torch.train.accumulators import HmmStats, ML_BUF


def split_gaussians(model: HmmModel, stats: HmmStats,
                    minocc: float = 0.0, maxg: int = 2 ** 30,
                    numgauss: int = -1, splitalpha: float = 1.0,
                    perturbation: float = 0.2) -> tuple[HmmModel, int]:
    """Returns (new model, number of splits)."""
    minocc = max(minocc, 1.0)
    buf = stats.buffers[ML_BUF]
    G = model.num_gaussians
    gamma = buf.gamma[:G].copy()
    S = model.num_states

    pdf_occ = np.zeros(S)
    occ_limit = np.zeros(S, dtype=np.int64)
    for s, (idx, w) in enumerate(model.mixtures):
        g_occ = buf.mix_gamma[s, :len(idx)]
        pdf_occ[s] = g_occ.sum()
        occ_limit[s] = int(np.floor(g_occ / (minocc / 2.0)).sum())

    mixg_minocc = 0.0
    if numgauss > 0:
        if G >= numgauss:
            return model, 0
        max_rel_error = 0.001
        mixg_minocc = 10 * model.dim
        temp = pdf_occ.sum() / max(S, 1)
        mixg_minocc = pow(temp, splitalpha) / (temp / mixg_minocc)
        interval = mixg_minocc
        growing = True
        for _ in range(30):
            num_mix_g = np.floor(
                np.power(pdf_occ, splitalpha) / mixg_minocc).astype(int)
            num_mix_g = np.minimum(num_mix_g, occ_limit)
            sizes = np.asarray([len(ix) for ix, _ in model.mixtures])
            total = int(np.maximum(np.minimum(num_mix_g, maxg),
                                   sizes).sum())
            if total > (1 + max_rel_error) * numgauss:
                if growing:
                    mixg_minocc *= 2
                    interval = mixg_minocc / 2.0
                else:
                    mixg_minocc += interval / 2.0
            elif total < numgauss:
                growing = False
                mixg_minocc -= interval / 2.0
            else:
                break
            if not growing:
                interval /= 2.0

    # membership map: gaussian -> mixtures using it
    users: dict[int, list] = {}
    mixtures = [(idx.copy().tolist(), w.copy().tolist())
                for idx, w in model.mixtures]
    for s, (idx, w) in enumerate(mixtures):
        for g in idx:
            users.setdefault(int(g), []).append(s)

    order = np.argsort(-gamma)
    means = [m for m in model.means]
    covars = [c for c in model.covars]
    num_splits = 0
    for g in order:
        g = int(g)
        ok = True
        for s in users.get(g, []):
            size = len(mixtures[s][0])
            if ((numgauss > 0 and
                 pow(pdf_occ[s], splitalpha) / (size + 1) < mixg_minocc)
                    or size >= maxg or gamma[g] < minocc):
                ok = False
                break
        if not ok or g not in users:
            continue
        # split: mean +- perturbation * sqrt(cov)
        delta = perturbation * np.sqrt(covars[g])
        new_idx = len(means)
        means.append(means[g] + delta)
        covars.append(covars[g].copy())
        means[g] = means[g] - delta
        for s in users[g]:
            idx, w = mixtures[s]
            k = idx.index(g)
            w[k] *= 0.5
            idx.append(new_idx)
            w.append(w[k])
        num_splits += 1

    new_model = HmmModel(
        dim=model.dim, cov_type=model.cov_type,
        means=np.asarray(means), covars=np.asarray(covars),
        mixtures=[(np.asarray(ix, dtype=np.int32), np.asarray(w))
                  for ix, w in mixtures],
        phones=list(model.phones),
        transitions={k: list(v) for k, v in model.transitions.items()},
        durations=model.durations)
    return new_model, num_splits


# ---------------------------------------------------------------------------
# Gaussian / mixture-component removal (estimate --delete / --mremove)
# ---------------------------------------------------------------------------

def _compact_pool(model: HmmModel, keep: np.ndarray,
                  mixtures: list) -> HmmModel:
    """Drop unkept Gaussians, remap mixture indices, renormalize."""
    new_id = np.cumsum(keep) - 1
    means = model.means[keep]
    covars = model.covars[keep]
    full = {int(new_id[g]): c for g, c in model.full_covars.items()
            if keep[g]}
    kind = [k for g, k in enumerate(model.gauss_kind) if keep[g]]
    out_mix = []
    for idx, w in mixtures:
        idx = np.asarray(idx, dtype=np.int64)
        w = np.asarray(w, dtype=np.float64)
        m = keep[idx]
        idx, w = new_id[idx[m]], w[m]
        s = w.sum()
        if s > 0:
            w = w / s
        out_mix.append((idx.astype(np.int32), w))
    return HmmModel(
        dim=model.dim, cov_type=model.cov_type, means=means,
        covars=covars, mixtures=out_mix, phones=model.phones,
        transitions=model.transitions, full_covars=full,
        gauss_kind=kind)


def delete_gaussians(model: HmmModel, stats: HmmStats,
                     minocc: float) -> tuple[HmmModel, int]:
    """Delete Gaussians whose ML occupancy is below ``minocc``
    (`aku/HmmSet.cc:1058-1140` delete_gaussians): every mixture keeps
    at least its maximum-weight component."""
    G = model.num_gaussians
    occ = stats.buffers[ML_BUF].gamma[:G]
    keep = occ >= minocc
    for idx, w in model.mixtures:
        idx = np.asarray(idx)
        if not keep[idx].any():
            keep[idx[int(np.argmax(w))]] = True      # retain the best
    removed = int(G - keep.sum())
    return _compact_pool(model, keep, list(model.mixtures)), removed


def remove_mixture_components(model: HmmModel,
                              min_weight: float) -> tuple[HmmModel, int]:
    """Remove mixture components at or below ``min_weight``
    (`aku/HmmSet.cc:1145-1180` remove_mixture_components): weights
    renormalize after each removal, so a component can climb back above
    the threshold; Gaussians left unused are dropped from the pool."""
    mixtures = []
    for idx, w in model.mixtures:
        idx = list(map(int, idx))
        w = list(map(float, w))
        while len(w) > 1:
            i = int(np.argmin(w))
            if w[i] > min_weight:
                break
            del idx[i], w[i]
            s = sum(w)
            w = [x / s for x in w]
        mixtures.append((np.asarray(idx, np.int32),
                         np.asarray(w, np.float64)))
    used = np.zeros(model.num_gaussians, dtype=bool)
    for idx, _ in mixtures:
        used[idx] = True
    removed = int((~used).sum())
    return _compact_pool(model, used, mixtures), removed
