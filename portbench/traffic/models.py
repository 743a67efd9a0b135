"""Acoustic models placed on the features of a run's own audio.

The mixtures come from the seed: for the recognition configuration each
tied state owns K Gaussians, for the training one each state draws K
of the G Gaussians (the program's `random_model` layout, so Gaussians
are shared).  The Gaussians are then placed as the program's
`feature_model` places them, but per state: each at a random frame of
its state (the state that first lists it) plus noise of a fifth of the
state's spread, with the state's own variance times 0.5 to 1.5, floored
at a hundredth of the global variance.  Posteriors then peak as a
trained model's do.  A Gaussian whose state never occurs in the audio
sits at a random frame plus noise of the global spread.
"""

from __future__ import annotations

import numpy as np
import torch


def mixtures(num_states: int, num_gaussians: int, K: int, shared: bool,
             seed: int) -> tuple[np.ndarray, np.ndarray]:
    """([S, K] Gaussian ids, [S, K] weights) drawn from ``seed``."""
    rng = np.random.default_rng([seed, 3])
    if shared:
        comp = np.stack([rng.choice(num_gaussians, K, replace=False)
                         for _ in range(num_states)])
    else:
        comp = np.arange(num_states * K).reshape(num_states, K)
    weights = rng.dirichlet(np.ones(K), size=num_states)
    return comp.astype(np.int64), weights


def place(comp: np.ndarray, num_gaussians: int, feats: torch.Tensor,
          states: torch.Tensor, seed: int,
          floor: float = 0.1, widen: float = 1.0
          ) -> tuple[np.ndarray, np.ndarray]:
    """Means and variances [G, D] (float64 numpy) placed on ``feats``
    [N, D] whose frames say ``states`` [N]."""
    dev = feats.device
    x = feats.double()
    N, D = x.shape
    S = comp.shape[0]
    gen = torch.Generator(device=dev).manual_seed(seed % (2 ** 63))
    count = torch.zeros(S, dtype=torch.float64, device=dev)
    count.index_add_(0, states, torch.ones(N, dtype=torch.float64,
                                           device=dev))
    s1 = torch.zeros((S, D), dtype=torch.float64, device=dev)
    s1.index_add_(0, states, x)
    s2 = torch.zeros((S, D), dtype=torch.float64, device=dev)
    s2.index_add_(0, states, x * x)
    gvar = x.var(0)
    mean_s = s1 / count.clamp(min=1)[:, None]
    var_s = (s2 / count.clamp(min=1)[:, None] - mean_s ** 2).clamp(min=0)
    var_s = torch.maximum(var_s, floor * gvar)
    # owner state of each Gaussian: the first (state, slot) listing it
    owner = np.full(num_gaussians, -1, np.int64)
    flat = comp.reshape(-1)
    first = np.unique(flat, return_index=True)
    owner[first[0]] = first[1] // comp.shape[1]
    owner = torch.as_tensor(owner, device=dev)
    order = torch.argsort(states, stable=True)
    start = torch.cumsum(count, 0) - count
    u = torch.rand(num_gaussians, generator=gen, device=dev,
                   dtype=torch.float64)
    z = torch.randn((num_gaussians, D), generator=gen, device=dev,
                    dtype=torch.float64)
    scale = torch.rand((num_gaussians, D), generator=gen, device=dev,
                       dtype=torch.float64) + 0.5
    anyf = (u * N).long().clamp(max=N - 1)
    own = owner.clamp(min=0)
    seen = (owner >= 0) & (count[own] > 0)
    pick = (start[own] + (u * count[own]).floor()).long().clamp(max=N - 1)
    frame = torch.where(seen, order[pick], anyf)
    spread = torch.where(seen[:, None], 0.2 * var_s[own].sqrt(),
                         gvar.sqrt().expand(num_gaussians, D))
    means = x[frame] + z * spread
    var = torch.where(seen[:, None], widen * var_s[own], 0.25 * gvar) * scale
    return means.cpu().numpy(), var.cpu().numpy()
