"""Gamma state-duration model estimation (`aku/dur_est.cc`).

Host copy of `aaltoasr_tpu/train/durations.py`.

Duration histograms come from state-level alignments; per-state gamma
parameters are fit by maximizing the likelihood with golden-section
search over the shape ``a`` (dur_est.cc:57-121: a in [1, 2*max(m^2/v,
1.5)-1], tolerance 0.01, b = mean/a), matching the reference's estimator
exactly so .dur files agree.
"""

from __future__ import annotations

import math

import numpy as np


def negative_gamma_loglikelihood(a, mean_log, log_mean):
    return a * (1 + log_mean - math.log(a)) + math.lgamma(a) \
        + (1 - a) * mean_log


def fit_gamma(hist: np.ndarray) -> tuple[float, float] | None:
    """ML gamma fit for a duration histogram (index i = duration i+1)."""
    hist = np.asarray(hist, dtype=np.float64)
    count = hist.sum()
    if count < 2:
        return None
    d = np.arange(1, len(hist) + 1, dtype=np.float64)
    mean = float((d * hist).sum() / count)
    var = float(((d - mean) ** 2 * hist).sum())
    var = max(var / (count - 1), 0.25)
    log_mean = math.log(mean)
    mean_log = float((np.log(d) * hist).sum() / count)

    r = (math.sqrt(5) - 1) / 2
    a = 1.0
    b = 2 * max(mean * mean / var, 1.5) - 1
    x1 = a + (1 - r) * (b - a)
    x2 = a + r * (b - 1)
    x1v = negative_gamma_loglikelihood(x1, mean_log, log_mean)
    x2v = negative_gamma_loglikelihood(x2, mean_log, log_mean)
    while b - a > 0.01:
        if x2v > x1v:
            b, x2, x2v = x2, x1, x1v
            x1 = a + (1 - r) * (b - a)
            x1v = negative_gamma_loglikelihood(x1, mean_log, log_mean)
        else:
            a, x1, x1v = x1, x2, x2v
            x2 = b - (1 - r) * (b - a)
            x2v = negative_gamma_loglikelihood(x2, mean_log, log_mean)
    a_out = (a + b) / 2
    return a_out, mean / a_out


class DurationAccumulator:
    """Per-state duration histograms from alignment segments."""

    def __init__(self, num_states: int, max_dur: int = 100):
        self.hist = np.zeros((num_states, max_dur), dtype=np.int64)

    def add_segment(self, state: int, duration: int) -> None:
        d = min(duration, self.hist.shape[1])
        if d >= 1:
            self.hist[state, d - 1] += 1

    def add_path(self, states: np.ndarray) -> None:
        """Accumulate from a per-frame tied-state sequence."""
        states = np.asarray(states)
        if len(states) == 0:
            return
        start = 0
        for t in range(1, len(states) + 1):
            if t == len(states) or states[t] != states[start]:
                self.add_segment(int(states[start]), t - start)
                start = t

    def estimate(self, skip_states: int = 0,
                 min_count: int = 2) -> np.ndarray:
        """[S, 2] gamma (a, b); zeros where no model (dur_est.cc:124-140)."""
        S = self.hist.shape[0]
        out = np.zeros((S, 2), dtype=np.float64)
        for s in range(S):
            if s < skip_states or self.hist[s].sum() < min_count:
                continue
            fit = fit_gamma(self.hist[s])
            if fit is not None:
                out[s] = fit
        return out
