"""Host-side E-step driver: recipes -> padded batches -> device stats.

Counterpart of `aaltoasr_tpu/train/driver.py` (the `stats` worker,
`aku/stats.cc:309-470`): iterates a recipe shard, builds each
utterance's transcript chain, pads into shape buckets, runs the batched
E-step (`train/estep.py`) on ``device`` and reduces into
reference-format accumulators.  ``device`` defaults to the GPU and, with
none present, raises before anything is read.  Graphs are stacked on the
host and uploaded once per bucket; each batch's statistics come back in
one fetch per key.  HMM networks (``hmmnet=`` / ``den-hmmnet=`` MIT-FST
files, `models/hmmnet.py`) run one utterance per device pass, as the
reference's do: the ML buffer from the numerator network, the MMI buffer
from the denominator, and the MPE num/den buffers from
`train/mpe.py`.
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from aaltoasr_tpu_torch.device import resolve_device
from aaltoasr_tpu_torch.formats.fst import read_fst
from aaltoasr_tpu_torch.formats.model_io import HmmModel
from aaltoasr_tpu_torch.formats.phn import read_phn
from aaltoasr_tpu_torch.formats.recipe import Recipe
from aaltoasr_tpu_torch.frontend.audio import read_audio
from aaltoasr_tpu_torch.frontend.generator import FeatureGenerator
from aaltoasr_tpu_torch.models.hmm import (
    TransitionTable, build_chain, pad_chain)
from aaltoasr_tpu_torch.models.hmmnet import compile_hmmnet, pad_hmmnet
from aaltoasr_tpu_torch.ops.gmm import GmmScorer
from aaltoasr_tpu_torch.train import estep
from aaltoasr_tpu_torch.train import mpe as mpe_mod
from aaltoasr_tpu_torch.train.accumulators import (
    HmmStats, ML_BUF, MMI_BUF, MPE_DEN_BUF, MPE_NUM_BUF, PDF_ML_FULL_STATS,
    PDF_ML_STATS, PDF_MMI_STATS, PDF_MPE_DEN_STATS, PDF_MPE_NUM_STATS)
from aaltoasr_tpu_torch.utils.profiling import count, span


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


def _fetch_mpe(out: dict) -> dict:
    """One utterance's MPE statistics (`train/mpe.py`) as numpy."""
    return {"num": {k: v[0] for k, v in fetch(out["num"]).items()},
            "den": {k: v[0] for k, v in fetch(out["den"]).items()},
            "log_likelihood": float(out["log_likelihood"][0]),
            "avg_accuracy": float(out["avg_accuracy"][0])}


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
        self.model = model
        self.table = TransitionTable.from_model(model)
        self.fg = FeatureGenerator(feature_config, device=self.device)
        self.scorer = GmmScorer.from_model(model, device=self.device)
        self.mode = mode
        self._phone_id = {p.label: i
                          for i, p in enumerate(model.phones)}
        self._membership = None
        self._center_class = None
        self._n_center = 0
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

    def graph_from_fst(self, fst) -> dict:
        """The shift-compiled padded graph of an HMM network (host
        numpy): fan at least 4, positions padded to ``pos_bucket``, and
        a model phone index per position (the mpfe-cps/mpfe modes)."""
        g, emit = compile_hmmnet(fst, self.table)
        P = int(g["num_positions"])
        P_pad = _round_up(max(P, 1), self.pos_bucket)
        F = max(g["in_src"].shape[1], 4)
        out = estep.shift_compile(pad_hmmnet(g, P_pad, fan=F))
        labels = [fst.arcs[ai].label for ai in emit] + [""] * (P_pad - P)
        out["phone"] = np.asarray([self._phone_id.get(lbl, 0)
                                   for lbl in labels], np.int32)
        return out

    def _run_batch(self, feats, T, graphs, full_stats: bool = False,
                   arc_feacount: bool = False, unit=None):
        """Batched E-step on the device: feats [B, T_pad, D], T [B] frame
        counts, graphs stacked on the device -> fetched numpy stats
        (spans ``estep.batch`` and ``estep.fetch``)."""
        with span("estep.batch", unit):
            n = torch.as_tensor(np.asarray(T, np.int64), device=self.device)
            dstats = estep.chain_stats(
                self.scorer, feats, graphs, n, self.table.num_slots,
                self.mode, full_stats=full_stats, arc_feacount=arc_feacount)
        with span("estep.fetch", unit):
            return fetch(dstats)

    def _run_graph(self, feats, T, graph, arc_feacount: bool = False):
        """One utterance (padded features on the device, a host graph)
        -> its numpy statistics."""
        out = self._run_batch(feats[None], [T],
                              estep.stack_graphs([graph], self.device),
                              full_stats=self.full_stats,
                              arc_feacount=arc_feacount)
        return {k: v[0] for k, v in out.items()}

    def utterance_stats(self, samples: np.ndarray, labels: list) -> dict:
        """One utterance's statistics (numpy, transcript chain)."""
        feats, T = self._padded_features(samples)
        return self._run_graph(feats, T, self._graph_from_chain(labels))

    def _mpe_stats_for(self, feats, T, num_graph, num_fst, den_fst,
                       errmode: str, max_seg_dur: int) -> dict:
        """The --mpe error mode of one utterance (stats.cc:676-721) ->
        numpy statistics: frame modes run on the device; segment modes
        build the accuracy table on the host from the numerator Viterbi
        alignment (`segment_table`)."""
        dev = self.device
        den_graph = self.graph_from_fst(den_fst)
        n = torch.tensor([T], device=dev)
        x = feats[None]
        if errmode in ("mpfe-pdf", "mpfe-cps", "mpfe"):
            if self._membership is None:
                self._membership = torch.as_tensor(
                    mpe_mod.phone_membership(self.model), device=dev)
            return _fetch_mpe(mpe_mod.mpe_stats(
                self.scorer, x, estep.stack_graphs([num_graph], dev),
                estep.stack_graphs([den_graph], dev), n,
                self.table.num_slots, mode=errmode,
                membership=self._membership))
        acc, den_cls, den_graph = self.segment_table(
            feats, T, num_graph, num_fst, den_graph, den_fst, errmode,
            max_seg_dur)
        return _fetch_mpe(mpe_mod.mpe_stats_seg(
            self.scorer, x, None, estep.stack_graphs([den_graph], dev), n,
            self.table.num_slots, acc, den_cls, max_seg_dur))

    def segment_table(self, feats, T, num_graph, num_fst, den_graph,
                      den_fst, errmode: str, max_seg_dur: int):
        """The segment modes' inputs (mpe / mwe / snfe) of one utterance:
        (accuracy table [1, T_pad+1, D+1, C] and denominator classes
        [1, P] on the device, the denominator graph with its segment
        instances).  The table is built on the host from the numerator
        Viterbi alignment: one fetch of the path."""
        dev = self.device
        if errmode == "mwe":
            if (num_fst is None or not num_fst.word_names
                    or not den_fst.word_names):
                raise ValueError(
                    "--errmode mwe needs word-level hmmnets (numerator "
                    "and denominator built from word graphs)")
            names = sorted(set(num_fst.word_names)
                           | set(den_fst.word_names))
            cid = {w: i for i, w in enumerate(names)}
            num_wi = num_graph["word_inst"]
            den_wi = den_graph["word_inst"]
            num_cls = np.asarray(
                [cid[num_fst.word_names[i]] if i >= 0 else 0
                 for i in num_wi], np.int32)
            den_cls = np.asarray(
                [cid[den_fst.word_names[i]] if i >= 0 else 0
                 for i in den_wi], np.int32)
            num_inst = np.where(num_wi >= 0, num_wi,
                                num_wi.shape[0] + np.arange(len(num_wi)))
            den_inst = np.where(den_wi >= 0, den_wi,
                                den_wi.shape[0] + np.arange(len(den_wi)))
            num_graph = dict(num_graph, inst=num_inst.astype(np.int32))
            den_graph = dict(den_graph, inst=den_inst.astype(np.int32))
            n_classes = len(names)
        else:
            # phone classes: distinct center phones of the model
            if self._center_class is None:
                centers = sorted({mpe_mod.extract_center_phone(p.label)
                                  for p in self.model.phones})
                cidx = {c: i for i, c in enumerate(centers)}
                self._center_class = np.asarray(
                    [cidx[mpe_mod.extract_center_phone(p.label)]
                     for p in self.model.phones], np.int32)
                self._n_center = len(centers)
            num_cls = self._center_class[num_graph["phone"]]
            den_cls = self._center_class[den_graph["phone"]]
            n_classes = self._n_center

        # numerator Viterbi alignment -> reference segments
        ng = estep.stack_graphs([num_graph], dev)
        gll = self.scorer.gaussian_log_likelihoods(feats[None].float())
        path, _ = estep.masked_viterbi(
            mpe_mod.search_obs(self.scorer, gll, ng), ng,
            torch.tensor([T], device=dev))
        del gll
        ref_segs = mpe_mod.ref_segments_from_path(
            path[0].cpu().numpy(), num_graph["inst"], num_cls, T)
        acc = mpe_mod.segment_accuracy_table(
            errmode, ref_segs, T, max_seg_dur, n_classes,
            pad_frames=int(feats.shape[0]))
        return (torch.as_tensor(acc, device=dev)[None],
                torch.as_tensor(den_cls.astype(np.int64), device=dev)[None],
                den_graph)

    def run_recipe_batched(self, recipe: Recipe, batch_size: int = 8,
                           info: int = 0) -> HmmStats:
        """Batched ML E-step: utterances bucketed by padded shape
        (T_pad, P_pad, F), each bucket run in batches of ``batch_size``
        (one device pass per batch).

        Spans (`utils/profiling.py`): ``estep.shard`` the call;
        ``estep.read``, ``estep.features`` and ``estep.compile`` per
        utterance; ``estep.upload`` per bucket (its graphs) and per batch
        (its stacked features); per batch ``estep.batch`` (the
        frame loops issued), ``estep.fetch`` (the host waits for the
        statistics) and ``estep.accumulate`` (into the host `HmmStats`).
        Counters ``estep.frames`` and ``estep.padded_frames``: each
        batch's valid frames and B x T_pad."""
        with span("estep.shard"):
            total = HmmStats.zeros(self.model, self.table)
            buckets: dict = {}
            for u, rinfo in enumerate(recipe):
                if info > 0:
                    print(f"Loading: {rinfo.audio_path}", file=sys.stderr)
                with span("estep.read", u):
                    samples, _ = read_audio(rinfo.audio_path,
                                            self.fg.sample_rate)
                    labels = [e.label
                              for e in read_phn(rinfo.transcript_path)]
                with span("estep.features", u):
                    feats, T = self._padded_features(samples)
                with span("estep.compile", u):
                    graph = self._graph_from_chain(labels)
                key = (int(feats.shape[0]), int(graph["pdf"].shape[0]),
                       int(graph["in_src"].shape[1]))
                buckets.setdefault(key, []).append(
                    (feats, graph, T, rinfo.audio_path))

            j = 0
            for items in buckets.values():
                with span("estep.upload", j):
                    graphs = estep.stack_graphs([c[1] for c in items],
                                                self.device)
                for i in range(0, len(items), batch_size):
                    chunk = items[i:i + batch_size]
                    with span("estep.upload", j):
                        feats = torch.stack([c[0] for c in chunk])
                    n_frames = [c[2] for c in chunk]
                    count("estep.frames", sum(n_frames))
                    count("estep.padded_frames",
                          feats.shape[0] * feats.shape[1])
                    out = self._run_batch(
                        feats, n_frames,
                        {k: v[i:i + batch_size] for k, v in graphs.items()},
                        unit=j)
                    with span("estep.accumulate", j):
                        for b, c in enumerate(chunk):
                            if _failed(float(out["log_likelihood"][b])):
                                print(f"Warning: no valid path for {c[3]}; "
                                      "skipping", file=sys.stderr)
                                self.failed_utterances.append(c[3])
                                continue
                            total.add(device_stats_to_hmm_stats(
                                self.model, self.table,
                                {k: v[b] for k, v in out.items()}))
                    j += 1
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
                   mmi: bool = False, mpe: bool = False,
                   errmode: str = "mpe",
                   max_seg_dur: int = 64) -> HmmStats:
        """Accumulate statistics over a recipe shard, one utterance per
        device pass (the path of `-M vit|mpv`, ``full_stats`` and the
        hmmnet/discriminative statistics).

        use_hmmnet: read hmmnet= FSTs instead of transcripts (-H);
        mmi: additionally run the den-hmmnet= network into the MMI
        buffer (stats.cc --mmi path);
        mpe: MPE statistics into the MPE num/den buffers (stats.cc
        --mpe); errmode selects the SegErrorEvaluator mode: mwe / mpe /
        mpfe-pdf / mpfe-cps / mpfe / snfe (stats.cc:346,489-496).
        max_seg_dur bounds the duration-augmented state of the
        segment-level modes.
        """
        mode = (PDF_ML_STATS | (PDF_MMI_STATS if mmi else 0)
                | (PDF_ML_FULL_STATS if self.full_stats else 0)
                | ((PDF_MPE_NUM_STATS | PDF_MPE_DEN_STATS)
                   if mpe else 0))
        total = HmmStats.zeros(self.model, self.table, mode)
        for rinfo in recipe:
            if info > 0:
                print(f"Processing file: {rinfo.audio_path}",
                      file=sys.stderr)
            samples, _ = read_audio(rinfo.audio_path, self.fg.sample_rate)
            feats, T = self._padded_features(samples)
            num_fst = None
            if use_hmmnet and rinfo.hmmnet_path:
                num_fst = read_fst(rinfo.hmmnet_path)
                graph = self.graph_from_fst(num_fst)
            else:
                graph = self._graph_from_chain(
                    [e.label for e in read_phn(rinfo.transcript_path)])
            # the discriminative path accumulates per SEGMENTED ARC
            # (collect_lattice_stats, stats.cc:225-306), so feacount
            # counts live (frame, arc) pairs there; the ML-only path
            # goes through the per-(frame, pdf) Segmentator maps
            utt = device_stats_to_hmm_stats(
                self.model, self.table,
                self._run_graph(feats, T, graph, arc_feacount=mmi or mpe),
                mode)
            if mmi or mpe:
                # collect_lattice_stats has no transition branch: the
                # reference's discriminative path leaves the .phs counts
                # at zero even with -t (stats.cc:225-306)
                utt.trans_acc[:] = 0.0
            if _failed(utt.num_ll):
                print(f"Warning: no valid path for "
                      f"{rinfo.audio_path}; skipping", file=sys.stderr)
                self.failed_utterances.append(rinfo.audio_path)
                continue
            if (mmi or mpe) and not rinfo.den_hmmnet_path:
                raise ValueError(
                    f"--mmi/--mpe requires den-hmmnet= in the recipe "
                    f"(missing for {rinfo.audio_path})")
            if mmi:
                den = self._run_graph(
                    feats, T,
                    self.graph_from_fst(read_fst(rinfo.den_hmmnet_path)),
                    arc_feacount=True)
                device_stats_to_hmm_stats(self.model, self.table, den, mode,
                                          buffer_id=MMI_BUF, stats=utt)
            if mpe:
                out = self._mpe_stats_for(
                    feats, T, graph, num_fst,
                    read_fst(rinfo.den_hmmnet_path), errmode, max_seg_dur)
                for buf_id, key in ((MPE_NUM_BUF, "num"),
                                    (MPE_DEN_BUF, "den")):
                    d = dict(out[key])
                    d["trans_acc"] = np.zeros(self.table.num_slots)
                    d["log_likelihood"] = out["log_likelihood"]
                    d["num_frames"] = T
                    device_stats_to_hmm_stats(
                        self.model, self.table, d, mode,
                        buffer_id=buf_id, stats=utt)
                utt.den_ll = out["avg_accuracy"]
                utt.mpe_score += out["avg_accuracy"]
            total.add(utt)
        return total
