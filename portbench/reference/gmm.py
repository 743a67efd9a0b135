"""Plain diagonal-GMM scoring and LNA normalization.

log N_g(x) = C_g - sum_d (x_d - mu_gd)^2 p_gd / 2 with C_g = sum_d
log(p_gd) / 2 (the reference's unnormalized constant,
`aku/Distributions.cc:1273-1287`); a state's log-likelihood is the
logsumexp of its components' plus their log weights; the LNA log-probs
are ``max(ll - logsumexp_s ll, log 1e-50)``, and the 2-byte codes
``int(-1820 lp + 0.5)`` with 0xFFFF below -36.008
(`aku/PhoneProbsToolbox.cc:93-124`).  The square is expanded into one
product, which float64 carries exactly enough.
"""

from __future__ import annotations

import math

import numpy as np
import torch

FLOOR = math.log(1e-50)


class Gmm:
    """A diagonal GMM on a device in ``dtype``: ``means``/``covars``
    [G, D], ``comp`` [S, K] Gaussian ids, ``logw`` [S, K]."""

    def __init__(self, means, covars, comp, weights, device, dtype):
        p = 1.0 / np.asarray(covars, np.float64)
        mu = np.asarray(means, np.float64)
        A = np.concatenate([-0.5 * p, mu * p], axis=1).T       # [2D, G]
        c = 0.5 * np.log(p).sum(1) - 0.5 * (mu * mu * p).sum(1)
        self.A = torch.as_tensor(A, dtype=dtype, device=device)
        self.c = torch.as_tensor(c, dtype=dtype, device=device)
        self.comp = torch.as_tensor(np.asarray(comp), dtype=torch.int64,
                                    device=device)
        w = np.asarray(weights, np.float64)
        self.logw = torch.as_tensor(
            np.where(w > 0, np.log(np.maximum(w, 1e-300)), -np.inf),
            dtype=dtype, device=device)
        self.dtype = dtype

    def gaussian_ll(self, x: torch.Tensor) -> torch.Tensor:
        """[T, D] -> [T, G]."""
        x = x.to(self.dtype)
        return torch.cat([x * x, x], dim=1) @ self.A + self.c

    def state_ll(self, x: torch.Tensor) -> torch.Tensor:
        """[T, D] -> [T, S]."""
        g = self.gaussian_ll(x)
        return torch.logsumexp(g[:, self.comp] + self.logw, dim=-1)


def lna_log_probs(state_ll: torch.Tensor) -> torch.Tensor:
    return torch.clamp(state_ll - torch.logsumexp(state_ll, -1, keepdim=True),
                       min=FLOOR)


def lna_codes(log_probs: torch.Tensor) -> torch.Tensor:
    """Log-probs -> 2-byte codes as int32."""
    lp = log_probs.double()
    v = torch.trunc(-1820.0 * lp + 0.5).to(torch.int32)
    return torch.where(lp < -36.008, torch.full_like(v, 0xFFFF),
                       v.clamp(0, 0xFFFF))


def code_gap(got: torch.Tensor, want: torch.Tensor) -> tuple[float, int, int]:
    """(summed step, largest step, codes compared) of [T, S] codes
    against the reference's, over the codes where either side is live
    (below 0xFFFF: both saturated is agreement, not a reading)."""
    got = got.to(torch.int64)
    want = want.to(torch.int64)
    live = (want < 0xFFFF) | (got < 0xFFFF)
    step = (got - want).abs()[live]
    return (float(step.sum()), int(step.max()) if step.numel() else 0,
            int(live.sum()))
