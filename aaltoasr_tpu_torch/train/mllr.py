"""Model-space CMLLR: fold per-class transforms into the Gaussian pool.

Host copy (numpy) of `apply_model_cmllr` in `aaltoasr_tpu/train/mllr.py`;
the CMLLR estimation there is not ported.
"""

from __future__ import annotations

import numpy as np

from aaltoasr_tpu_torch.formats.model_io import HmmModel


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
