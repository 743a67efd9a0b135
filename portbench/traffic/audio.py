"""Planted audio: 16 kHz samples that say a state plan.

Every tied state has its own seeded spectral signature (a few partials
with their frequencies, amplitudes and phases); the long and short
silences are quiet.  The 128 samples centred on frame t's window follow
the state planned for frame t, so a frame's features come from its own
state.  Samples are rounded to 16-bit values, as audio read from a PCM
file is.
"""

from __future__ import annotations

import numpy as np
import torch

HOP = 128           # samples a frame at 16 kHz and 125 frames/s
WINDOW = 256        # the configuration's window: 2 * rate / frame rate


def num_samples(T: int) -> int:
    """Samples that give exactly ``T`` frames: (S - W - 1) // HOP + 1."""
    return HOP * (T - 1) + WINDOW + 1


def signatures(num_states: int, quiet_states, seed: int,
               partials: int = 4) -> dict:
    """Per-state partials: frequency [S, P] Hz in 100-7,800, amplitude
    log-uniform in 200-4,000 (quiet states 3% of it), phase."""
    rng = np.random.default_rng([seed, 2])
    freq = rng.uniform(100.0, 7800.0, (num_states, partials))
    amp = np.exp(rng.uniform(np.log(200.0), np.log(4000.0),
                             (num_states, partials)))
    amp[np.asarray(list(quiet_states), np.int64)] *= 0.03
    phase = rng.uniform(0.0, 2 * np.pi, (num_states, partials))
    return {"freq": freq, "amp": amp, "phase": phase}


def synthesize(plans: list, sig: dict, seed: int, device,
               noise: float = 60.0) -> tuple[torch.Tensor, np.ndarray]:
    """[B] plans -> ([B, N] float32 samples on ``device``, zero past each
    utterance's end; [B] sample counts).  Noise N(0, noise^2) comes from
    a generator on the device seeded with ``seed``."""
    lens = np.asarray([num_samples(len(p)) for p in plans], np.int64)
    B, N = len(plans), int(lens.max())
    T_max = max(len(p) for p in plans)
    plan = torch.zeros((B, T_max), dtype=torch.int64, device=device)
    for b, p in enumerate(plans):
        plan[b, :len(p)] = torch.as_tensor(p, dtype=torch.int64,
                                           device=device)
    n = torch.arange(N, device=device, dtype=torch.int64)
    out = torch.empty((B, N), dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
    freq = torch.as_tensor(sig["freq"], dtype=torch.float64, device=device)
    amp = torch.as_tensor(sig["amp"], dtype=torch.float64, device=device)
    phase = torch.as_tensor(sig["phase"], dtype=torch.float64,
                            device=device)
    for b in range(B):           # one utterance at a time bounds memory
        T = len(plans[b])
        t = ((n - HOP // 2) // HOP).clamp(0, T - 1)
        s = plan[b, t]                                     # [N]
        arg = (2 * np.pi / 16000.0) * n.double()[:, None] * freq[s] + phase[s]
        x = (amp[s] * torch.sin(arg)).sum(-1)
        x = x + noise * torch.randn(N, generator=gen, device=device,
                                    dtype=torch.float64)
        x[int(lens[b]):] = 0.0
        out[b] = x.round().clamp(-32768, 32767).float()
    return out, lens
