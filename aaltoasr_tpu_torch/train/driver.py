"""Host-side E-step driver: recipes -> padded batches -> device stats.

Counterpart of `aaltoasr_tpu/train/driver.py` (the `stats` worker,
`aku/stats.cc:309-470`): iterates a recipe shard, builds each
utterance's transcript chain, pads into shape buckets, runs the batched
E-step (`train/estep.py`) on ``device`` and reduces into
reference-format accumulators.  ``device`` defaults to the GPU and, with
none present, raises before anything is read.  Graphs are stacked on the
host and uploaded once per bucket; each batch's statistics come back in
one fetch per key.  HMM-network E-steps (``use_hmmnet``) and the
discriminative buffers (``mmi``, ``mpe``) belong to the hmmnet half of
training and raise `NotImplementedError`.
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from aaltoasr_tpu_torch.device import resolve_device
from aaltoasr_tpu_torch.formats.model_io import HmmModel
from aaltoasr_tpu_torch.formats.phn import read_phn
from aaltoasr_tpu_torch.formats.recipe import Recipe
from aaltoasr_tpu_torch.frontend.audio import read_audio
from aaltoasr_tpu_torch.frontend.generator import FeatureGenerator
from aaltoasr_tpu_torch.models.hmm import (
    TransitionTable, build_chain, pad_chain)
from aaltoasr_tpu_torch.ops.gmm import GmmScorer
from aaltoasr_tpu_torch.train import estep
from aaltoasr_tpu_torch.train.accumulators import (
    HmmStats, ML_BUF, PDF_ML_FULL_STATS, PDF_ML_STATS)


def fetch(dstats: dict) -> dict:
    """A device statistics dict as numpy arrays: one transfer per key,
    for the whole batch."""
    return {k: v.cpu().numpy() for k, v in dstats.items()}


def device_stats_to_hmm_stats(model: HmmModel, table: TransitionTable,
                              dstats, mode: int = PDF_ML_STATS,
                              buffer_id: int = ML_BUF,
                              stats: HmmStats | None = None) -> HmmStats:
    """One utterance's E-step statistics (numpy arrays, e.g. a batch
    entry of `fetch`) into host HmmStats.

    ``buffer_id`` selects the accumulator; pass an existing ``stats`` to
    fill a second buffer of the same object."""
    if stats is None:
        stats = HmmStats.zeros(model, table, mode)
    buf = stats.buffers[buffer_id]
    G = model.num_gaussians
    S = model.num_states
    buf.gamma[:] = np.asarray(dstats["gamma"], dtype=np.float64)[:G]
    # aux gamma = sum of |component gamma| (Mixture::accumulate,
    # Distributions.cc:2157); our per-frame gammas are non-negative per
    # buffer, so the sum of absolutes equals the sum
    buf.aux_gamma[:] = np.abs(buf.gamma)
    buf.mean_acc[:] = np.asarray(dstats["mean_acc"], dtype=np.float64)[:G]
    buf.sec_acc[:] = np.asarray(dstats["sec_acc"], dtype=np.float64)[:G]
    buf.feacount[:] = np.asarray(dstats["feacount"], dtype=np.int64)[:G]
    if "sec_acc_full" in dstats:
        buf.ensure_full()
        buf.full_acc[:] = np.asarray(dstats["sec_acc_full"],
                                     dtype=np.float64)[:G]
    mix = np.asarray(dstats["mix_gamma"], dtype=np.float64)[:S]
    K = buf.mix_gamma.shape[1]
    buf.mix_gamma[:, :] = mix[:, :K]
    if "mix_ll" in dstats:
        buf.mix_ll[:] = np.asarray(dstats["mix_ll"],
                                   dtype=np.float64)[:S]
    if buffer_id == ML_BUF:
        stats.trans_acc[:] = np.asarray(dstats["trans_acc"],
                                        dtype=np.float64)
        stats.num_ll = float(dstats["log_likelihood"])
        stats.num_frames = int(dstats["num_frames"])
    else:
        stats.den_ll = float(dstats["log_likelihood"])
    return stats


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def _failed(ll: float) -> bool:
    """No valid path: the dense FB has no beams, so a dead utterance
    means broken inputs (stats.cc:79-100 beam-retry analog)."""
    return not math.isfinite(ll) or ll <= -1e29


class EStepDriver:
    """Recipe -> statistics, with shape bucketing."""

    def __init__(self, model: HmmModel, feature_config,
                 mode: str = "bw", time_bucket: int = 256,
                 pos_bucket: int = 64, full_stats: bool = False,
                 device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        if mode == "mpv":
            raise estep.later("multipath Viterbi statistics (-M mpv)")
        self.model = model
        self.table = TransitionTable.from_model(model)
        self.fg = FeatureGenerator(feature_config, device=self.device)
        self.scorer = GmmScorer.from_model(model, device=self.device)
        self.mode = mode
        self._phone_id = {p.label: i
                          for i, p in enumerate(model.phones)}
        self.full_stats = full_stats
        self.time_bucket = time_bucket
        self.pos_bucket = pos_bucket
        self.failed_utterances: list = []

    def _padded_features(self, samples):
        feats = self.fg.features(samples)
        T = feats.shape[0]
        T_pad = _round_up(T, self.time_bucket)
        if T_pad > T:
            feats = torch.cat([feats, feats.new_zeros((T_pad - T,
                                                       feats.shape[1]))])
        return feats, T

    def _graph_from_chain(self, labels) -> dict:
        """The shift-compiled padded chain of ``labels`` (host numpy)."""
        chain = build_chain(self.model, self.table, labels)
        P_pad = _round_up(chain.num_positions, self.pos_bucket)
        out = estep.shift_compile(pad_chain(chain, P_pad, fan=4))
        phone = np.zeros(P_pad, dtype=np.int32)
        lbl_ids = [self._phone_id.get(l, 0) for l in labels]
        phone[:chain.num_positions] = np.asarray(
            lbl_ids, np.int32)[chain.phone_index]
        out["phone"] = phone
        return out

    def _run_batch(self, feats, T, graphs, full_stats: bool = False):
        """Batched E-step on the device: feats [B, T_pad, D], T [B] frame
        counts, graphs stacked on the device -> fetched numpy stats."""
        n = torch.as_tensor(np.asarray(T, np.int64), device=self.device)
        return fetch(estep.chain_stats(
            self.scorer, feats, graphs, n, self.table.num_slots, self.mode,
            full_stats=full_stats))

    def utterance_stats(self, samples: np.ndarray, labels: list) -> dict:
        """One utterance's statistics (numpy, transcript chain)."""
        feats, T = self._padded_features(samples)
        graph = estep.stack_graphs([self._graph_from_chain(labels)],
                                   self.device)
        out = self._run_batch(feats[None], [T], graph,
                              full_stats=self.full_stats)
        return {k: v[0] for k, v in out.items()}

    def run_recipe_batched(self, recipe: Recipe, batch_size: int = 8,
                           info: int = 0) -> HmmStats:
        """Batched ML E-step: utterances bucketed by padded shape
        (T_pad, P_pad, F), each bucket run in batches of ``batch_size``
        (one device pass per batch)."""
        total = HmmStats.zeros(self.model, self.table)
        buckets: dict = {}
        for rinfo in recipe:
            if info > 0:
                print(f"Loading: {rinfo.audio_path}", file=sys.stderr)
            samples, _ = read_audio(rinfo.audio_path, self.fg.sample_rate)
            feats, T = self._padded_features(samples)
            graph = self._graph_from_chain(
                [e.label for e in read_phn(rinfo.transcript_path)])
            key = (int(feats.shape[0]), int(graph["pdf"].shape[0]),
                   int(graph["in_src"].shape[1]))
            buckets.setdefault(key, []).append(
                (feats, graph, T, rinfo.audio_path))

        for items in buckets.values():
            graphs = estep.stack_graphs([c[1] for c in items], self.device)
            for i in range(0, len(items), batch_size):
                chunk = items[i:i + batch_size]
                out = self._run_batch(
                    torch.stack([c[0] for c in chunk]),
                    [c[2] for c in chunk],
                    {k: v[i:i + batch_size] for k, v in graphs.items()})
                for b, c in enumerate(chunk):
                    if _failed(float(out["log_likelihood"][b])):
                        print(f"Warning: no valid path for {c[3]}; "
                              "skipping", file=sys.stderr)
                        self.failed_utterances.append(c[3])
                        continue
                    total.add(device_stats_to_hmm_stats(
                        self.model, self.table,
                        {k: v[b] for k, v in out.items()}))
        return total

    def run_recipe_aligned(self, recipe: Recipe,
                           info: int = 0) -> HmmStats:
        """stats -O: accumulate along FIXED state-segmented alignment
        phns (the reference's PhnReader-as-Segmentator path,
        `stats.cc:73-177` simple_train + `PhnReader.cc:220-280`), on the
        host in float64 (a copy of the reference package's loop):

        * per frame, the aligned state's mixture accumulates with
          gamma 1 (component split by within-mixture posteriors,
          `Distributions.cc:2134-2160`),
        * transitions: the frame that STARTS a segment counts the
          previous state's first out arc; every other frame counts the
          current state's self arc (so each frame counts exactly one),
        * loglikelihood sums ln(state likelihood) + ln(transition
          prob) per frame.
        """
        total = HmmStats.zeros(
            self.model, self.table,
            PDF_ML_STATS | (PDF_ML_FULL_STATS
                            if self.full_stats else 0))
        model = self.model
        shift = int(round(self.fg.sample_rate / self.fg.frame_rate))
        means = np.asarray(model.means, np.float64)
        covars = np.asarray(model.covars, np.float64)
        # reference Gaussians carry no (2*pi)^(-D/2) factor
        # (DiagonalGaussian::set_constant, Distributions.cc:1274-1283)
        logdet = np.sum(np.log(covars), axis=1)
        # first out arc per state (PhnReader picks the first
        # target_offset != 0 transition for state-labeled phns)
        out_slot = {}
        for i, (s, o) in enumerate(zip(self.table.source,
                                       self.table.offset)):
            s, o = int(s), int(o)
            if o != 0 and s not in out_slot:
                out_slot[s] = i
        self_slot = {int(s): i for i, (s, o) in enumerate(
            zip(self.table.source, self.table.offset))
            if int(o) == 0}
        tprob = np.asarray(self.table.prob, np.float64)
        buf = total.buffers[ML_BUF]
        for rinfo in recipe:
            if info > 0:
                print(f"Processing file: {rinfo.audio_path}",
                      file=sys.stderr)
            samples, _ = read_audio(rinfo.audio_path,
                                    self.fg.sample_rate)
            feats = self.fg.features(samples).cpu().numpy().astype(
                np.float64)
            entries = read_phn(rinfo.alignment_path
                               or rinfo.transcript_path)
            prev_state = None
            for e in entries:
                ph = model.phones[self._phone_id[e.label]]
                st = int(ph.states[max(e.state, 0)])
                comp, w = model.mixtures[st]
                comp = np.asarray(comp)
                w = np.asarray(w, np.float64)
                f0, f1 = e.start // shift, e.end // shift
                for t in range(f0, min(f1, feats.shape[0])):
                    x = feats[t]
                    d = x[None, :] - means[comp]
                    logn = -0.5 * (
                        np.sum(d * d / covars[comp], axis=1)
                        + logdet[comp])
                    like = w * np.exp(logn)
                    tot = float(like.sum())
                    buf.mix_ll[st] += np.log(max(tot, 1e-300))
                    total.num_ll += np.log(max(tot, 1e-300))
                    if tot > 0:
                        g = like / tot
                        buf.gamma[comp] += g
                        buf.mean_acc[comp] += g[:, None] * x[None, :]
                        buf.sec_acc[comp] += g[:, None] * (x * x)[None]
                        buf.aux_gamma[comp] += np.abs(g)
                        buf.feacount[comp] += 1
                        buf.mix_gamma[st, :len(comp)] += g
                        if self.full_stats:
                            buf.ensure_full()
                            buf.full_acc[comp] += (
                                g[:, None, None]
                                * np.outer(x, x)[None])
                    if t == f0 and prev_state is not None:
                        tr = out_slot[prev_state]
                    else:
                        tr = self_slot[st]
                    total.trans_acc[tr] += 1.0
                    total.num_ll += np.log(max(tprob[tr], 1e-300))
                    total.num_frames += 1
                prev_state = st
        return total

    def run_recipe(self, recipe: Recipe, info: int = 0,
                   use_hmmnet: bool = False,
                   mmi: bool = False, mpe: bool = False) -> HmmStats:
        """Accumulate statistics over a recipe shard, one utterance per
        device pass (the path of `-M vit` and ``full_stats``)."""
        if use_hmmnet:
            raise estep.later("training on hmmnet= networks (-H)")
        if mmi or mpe:
            raise estep.later("discriminative statistics (--mmi/--mpe)")
        mode = PDF_ML_STATS | (PDF_ML_FULL_STATS if self.full_stats else 0)
        total = HmmStats.zeros(self.model, self.table, mode)
        for rinfo in recipe:
            if info > 0:
                print(f"Processing file: {rinfo.audio_path}",
                      file=sys.stderr)
            samples, _ = read_audio(rinfo.audio_path, self.fg.sample_rate)
            utt = device_stats_to_hmm_stats(
                self.model, self.table, self.utterance_stats(
                    samples, [e.label for e in
                              read_phn(rinfo.transcript_path)]), mode)
            if _failed(utt.num_ll):
                print(f"Warning: no valid path for "
                      f"{rinfo.audio_path}; skipping", file=sys.stderr)
                self.failed_utterances.append(rinfo.audio_path)
                continue
            total.add(utt)
        return total
