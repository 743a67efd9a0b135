"""LDA transform estimation (`aku/lda.cc`).

Class-discriminant linear transform over (usually context-spliced)
features; classes are tied states from alignments.  The solve follows
the reference exactly so `lda -w` configs agree
(`aku/lda.cc:246-266,376-455`):

* per-state full statistics (gamma, mean, second moment;
  `Distributions.cc:34-151` conventions: mean = sum/gamma, covariance =
  moment/gamma - mean mean^T),
* state selection: top ``max_classes`` states by gamma with
  gamma >= ``min_gamma`` (lda.cc:246-253), optional exclusion of
  silence states (lda.cc:255-263),
* B = sum_s min(gamma_s, max_gamma) (mu_s - mu)(mu_s - mu)^T and
  W = sum_s min(gamma_s, max_gamma) Cov_s over the selected states,
  with the global mean/covariance taken over the selected states'
  frames only (pass 2 accumulates whole-data stats inside the
  selected-state branch, lda.cc:355-366),
* eigendecomposition of W^-1 B, eigenpairs ordered by descending
  |eigenvalue| (the lapackpp LaEigSolve convention lda.cc:420 asserts),
  first ``out_dim`` eigenvectors as columns of the projection P,
* whitening in the projected space: C = P^T Cov P, C = V L V^T, final
  LDA = diag(1/sqrt(L)) V^T P^T  (lda.cc:429-448), rows ordered by
  descending |L|.

Eigenvector SIGNS are solver-dependent (dgeev vs numpy); consumers that
compare matrices cross-implementation should normalize each output row's
sign.

Host copy of `aaltoasr_tpu/train/lda.py`.
"""

from __future__ import annotations

import numpy as np


class LdaAccumulator:
    def __init__(self, num_classes: int, dim: int):
        self.gamma = np.zeros(num_classes)
        self.sums = np.zeros((num_classes, dim))
        self.moments = np.zeros((num_classes, dim, dim))

    def add(self, cls: int, feats: np.ndarray) -> None:
        feats = np.atleast_2d(np.asarray(feats, dtype=np.float64))
        self.gamma[cls] += feats.shape[0]
        self.sums[cls] += feats.sum(0)
        self.moments[cls] += feats.T @ feats

    def solve(self, out_dim: int, min_gamma: float = 0.0,
              max_gamma: float = 1e6, max_classes: int | None = None,
              exclude: tuple = ()) -> np.ndarray:
        """[out_dim, D] LDA matrix (rows = whitened discriminants)."""
        # state selection (lda.cc:246-263)
        order = np.argsort(-self.gamma, kind="stable")
        if max_classes is None:
            max_classes = len(self.gamma)
        selected = [int(s) for s in order[:max_classes]
                    if self.gamma[s] >= max(min_gamma, 1e-12)
                    and int(s) not in set(exclude)]

        D = self.sums.shape[1]
        tot_gamma = sum(self.gamma[s] for s in selected)
        tot_sum = sum(self.sums[s] for s in selected)
        tot_moment = sum(self.moments[s] for s in selected)
        dmean = tot_sum / tot_gamma
        dcov = tot_moment / tot_gamma - np.outer(dmean, dmean)

        B = np.zeros((D, D))
        W = np.zeros((D, D))
        for s in selected:
            g = min(self.gamma[s], max_gamma)
            mu = self.sums[s] / self.gamma[s]
            dm = mu - dmean
            B += g * np.outer(dm, dm)
            W += g * (self.moments[s] / self.gamma[s] - np.outer(mu, mu))

        vals, vecs = np.linalg.eig(np.linalg.solve(W, B))
        idx = np.argsort(-np.abs(vals.real), kind="stable")
        pca = vecs[:, idx[:out_dim]].real          # [D, d]

        fea_cov = pca.T @ dcov @ pca               # symmetric [d, d]
        fvals, fvecs = np.linalg.eigh(fea_cov)
        fidx = np.argsort(-np.abs(fvals), kind="stable")
        fvals, fvecs = fvals[fidx], fvecs[:, fidx]
        scale = 1.0 / np.sqrt(fvals)
        return (scale[:, None] * fvecs.T) @ pca.T  # [d, D]
