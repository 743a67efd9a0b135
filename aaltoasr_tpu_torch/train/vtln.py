"""VTLN warp-factor estimation by ML grid search (`aku/vtln.cc`).

Counterpart of `aaltoasr_tpu/train/vtln.py`.  For each speaker, evaluate
the likelihood of their data under a grid of warp factors (default
radius 0.1, 21 points around the current warp, vtln.cc:173-221) and
keep the argmax.  The warp enters the frontend as a runtime parameter
(the VTLN module's [F, F] interpolation matrix), so the grid is a batch
axis: the frontend runs once with one matrix per candidate
(`FeatureGenerator.features_stacked`, the generator's own parameters
untouched), and the likelihood pass runs once over [W, T, D] with the
utterance's chain graph built once and shared by every row.  Each
utterance ends in one fetch of its [W] curve.
"""

from __future__ import annotations

import numpy as np
import torch

from aaltoasr_tpu_torch.device import ieee_float32
from aaltoasr_tpu_torch.formats.feaconf import ModuleConfig
from aaltoasr_tpu_torch.models.hmm import build_chain, pad_chain
from aaltoasr_tpu_torch.ops.logsemiring import logsumexp
from aaltoasr_tpu_torch.train import estep


def warp_grid(center: float = 1.0, radius: float = 0.1,
              size: int = 21) -> np.ndarray:
    """center - radius .. center + radius inclusive (vtln.cc:72-73)."""
    if size <= 1:
        return np.asarray([center])
    return center - radius + np.arange(size) * (2 * radius / (size - 1))


class VtlnEstimator:
    """Grid-search warp estimation over a speaker's utterances."""

    def __init__(self, model, table, scorer, fg, vtln_module: str,
                 radius: float = 0.1, size: int = 21):
        self.model = model
        self.table = table
        self.scorer = scorer
        self.fg = fg
        self.vtln_module = vtln_module
        self.radius = radius
        self.size = size
        self._grids = {}        # warps -> the module's stacked parameters

    def _warp_features(self, samples, warps, num_frames=None):
        """[W, T_pad, D] features, one row per candidate warp (the
        grid's warp matrices are built on the host once per grid)."""
        key = tuple(float(w) for w in warps)
        if key not in self._grids:
            op = self.fg.ops[self.vtln_module]
            per_warp = []
            for w in key:
                cfg = ModuleConfig()
                cfg.set("warp_factor", w)
                per_warp.append(op.set_parameters(cfg))
            self._grids[key] = {k: np.stack([np.asarray(p[k])
                                             for p in per_warp])
                                for k in per_warp[0]}
        return self.fg.features_stacked(samples, self.vtln_module,
                                        self._grids[key], num_frames)

    def utterance_lls(self, samples, labels, warps) -> np.ndarray:
        """Total data log-likelihood per candidate warp for one utterance
        (the forward pass of the transcript chain)."""
        chain = build_chain(self.model, self.table, labels)
        with ieee_float32():
            feats = self._warp_features(samples, warps)
            gll = self.scorer.gaussian_log_likelihoods(feats)  # [W, T, Gp]
        W, T = feats.shape[:2]
        dev = feats.device
        graph = {k: v.expand((W,) + tuple(v.shape[1:]))
                 for k, v in estep.stack_graphs(
                     [pad_chain(chain, chain.num_positions)], dev).items()}
        obs_pos = estep.chain_observations(self.scorer, gll, graph)[4]
        n = torch.full((W,), T, dtype=torch.int64, device=dev)
        return estep.masked_forward_log_likelihood(
            obs_pos, graph, n).cpu().numpy()

    def utterance_lls_aligned(self, samples, frame_states,
                              warps) -> np.ndarray:
        """Fixed-segmentation likelihood per warp (the reference's -O
        path: PhnReader over an existing alignment as Segmentator,
        `vtln.cc:88-117` compute_vtln_log_likelihoods with per-frame
        probability 1): sum_t max(ln pdf_ll(state_t), ln 1e-50)."""
        S = int(np.asarray(samples).shape[0])
        T = min(self.fg.num_frames(S), len(frame_states))
        sc = self.scorer
        with ieee_float32():
            feats = self._warp_features(samples, warps, num_frames=T)[:, :T]
            gll = sc.gaussian_log_likelihoods(feats)           # [W, T, Gp]
        states = torch.as_tensor(np.asarray(frame_states[:T], np.int64),
                                 device=feats.device)
        cidx = sc.comp_idx[states]                             # [T, K]
        comp = torch.gather(gll, 2, cidx.expand(
            (gll.shape[0],) + tuple(cidx.shape)))              # [W, T, K]
        per = logsumexp(comp + sc.comp_logw[states], dim=-1)   # [W, T]
        per = torch.clamp(per, min=float(np.log(1e-50)))
        return per.sum(1).cpu().numpy()

    def estimate_speaker(self, utterances, center: float = 1.0,
                         aligned: bool = False):
        """utterances: list of (samples, labels) — or, with
        aligned=True, (samples, frame_state_indices) — returns
        (best_warp, per-warp total lls, warps)."""
        warps = warp_grid(center, self.radius, self.size)
        total = np.zeros(len(warps))
        for samples, labels in utterances:
            if aligned:
                total += self.utterance_lls_aligned(samples, labels, warps)
            else:
                total += self.utterance_lls(samples, labels, warps)
        best = warps[int(np.argmax(total))]
        return float(best), total, warps


def alignment_frame_states(model, entries, samples_per_frame=128):
    """Expand a state-segmented alignment (.phn with 'label.N' lines
    and sample-number times, the `align` output convention) into a
    per-frame model-state index array (PhnReader frame mapping:
    frame = sample / (sample_rate/frame_rate))."""
    phone_states = {p.label: p.states for p in model.phones}
    end_frame = int(entries[-1].end) // samples_per_frame
    out = np.zeros(end_frame, np.int32)
    for e in entries:
        s = int(e.start) // samples_per_frame
        t = int(e.end) // samples_per_frame
        st = e.state if e.state >= 0 else 0
        out[s:t] = phone_states[e.label][st]
    return out
