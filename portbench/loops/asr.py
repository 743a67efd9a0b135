"""Recognition cells: the set-up they share and their two loops.

Set-up, from the seed: the configuration's task (fixed by its own
seed), the run's utterance lengths, planted plans and audio, the model
placed on the audio's reference features, and the files the program
reads.  Then the program is built as its entry points build it:
`Toolbox` from the .ph/.dur, lexicon and ARPA files, `PhoneProbs` with
both kernels (`fused=True`) from the model files and the feature
configuration.

The loops (``loop`` in a workload file):

- ``dense``: batches of audio already on the device through
  `FeatureGenerator.features_batch`, `FusedGmmScorer.lna_log_probs` and
  `DenseBeamSearch.decode_batch(lattice=False)` to 1-best words.
- ``stream``: `decode_stream`'s block loop: each block's audio is
  appended to the running buffer, then `features_range`,
  `lna_log_probs`, `StreamingDecoder.push_frames` and `partial()`;
  `result()` and `reset()` between utterances.

Loops of other shapes are files of their own (`portbench/loops/<loop>.py`
with a module-level ``CELL``, see `run.loop_class`), built on `Cell`,
`AsrData` (which takes a task of its own) and `build_toolbox`.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from portbench.harness import Laps, p90, sync
from portbench.reference import frontend as ref_fe
from portbench.reference.gmm import Gmm, code_gap, lna_codes, lna_log_probs
from portbench.reference.words import word_errors
from portbench.traffic import audio, files, models, plan
from portbench.traffic.task import decode_task

FRAME_RATE = 125.0


class AsrData:
    """Inputs of a recognition run, made from the seed: ``plans``,
    ``truth`` (planted word strings), ``samples`` [U, N] on the device
    with ``num_samples`` [U], the model's arrays and the files.  ``task``
    is a task of `traffic.task.decode_task`'s shape, by default the one
    ``cfg["task"]`` names."""

    def __init__(self, cfg: dict, wl: dict, seed: int, device, workdir: str,
                 laps: Laps, task: dict | None = None):
        self.task = task = task or decode_task(**cfg["task"])
        task["durations"] = np.round(task["durations"], 4)
        self.lengths = plan.run_lengths(wl["lengths"], FRAME_RATE, seed)
        self.plans, words = plan.plans(task, self.lengths, seed, "words")
        self.truth = [[task["words"][w] for w in ws] for ws in words]
        S = task["num_states"]
        quiet = [s for lbl in ("_", "__") for s in task["phones"][lbl]]
        sig = audio.signatures(S, quiet, seed)
        self.samples, self.num_samples = audio.synthesize(
            self.plans, sig, seed, device)
        sync(device)
        laps.lap("traffic")
        K = cfg["model"]["components"]
        self.comp, self.weights = models.mixtures(S, S * K, K, False, seed)
        tab = ref_fe.tables(device, torch.float64)
        feats = torch.cat([ref_fe.features(
            self.samples[u, :self.num_samples[u]], tab)
            for u in range(len(self.plans))])
        states = torch.as_tensor(np.concatenate(self.plans), device=device)
        self.means, self.covars = models.place(self.comp, S * K, feats,
                                               states, seed)
        del feats
        laps.lap("model")
        base = os.path.join(workdir, "am")
        self.paths = files.write_model(
            base, task["phones"], task["transitions"], self.means,
            self.covars, self.comp, self.weights, task["durations"])
        self.paths["lexicon"] = files.write_text(
            os.path.join(workdir, "lex.txt"), "\n".join(task["lex_lines"])
            + "\n")
        self.paths["lm"] = os.path.join(workdir, "lm.arpa")
        files.write_arpa(self.paths["lm"], task["vocab"], task["ngrams"])
        self.paths["cfg"] = files.write_text(
            os.path.join(workdir, "feats.cfg"), cfg["feature_config"])
        self.device = device
        laps.lap("files")

    def audio_s(self, u: int) -> float:
        return float(self.num_samples[u]) / ref_fe.RATE

    def reference_log_probs(self, u: int,
                            dtype=torch.float64) -> torch.Tensor:
        """[T, S] LNA log-probs of utterance ``u`` by the plain reference
        in ``dtype`` (float32: TF32 products, the control)."""
        tab = ref_fe.tables(self.device, dtype)
        x = ref_fe.features(self.samples[u, :self.num_samples[u]], tab, dtype)
        return lna_log_probs(self._gmm(dtype).state_ll(x))

    def reference_codes(self, u: int) -> torch.Tensor:
        return lna_codes(self.reference_log_probs(u))

    def _gmm(self, dtype) -> Gmm:
        key = ("gmm", dtype)
        if key not in self.__dict__:
            self.__dict__[key] = Gmm(self.means, self.covars, self.comp,
                                     self.weights, self.device, dtype)
        return self.__dict__[key]


def code_checks(data: AsrData, outputs: dict) -> list:
    """The LNA numbers of utterances ``outputs`` ({u: [T, S] log-probs
    or codes}) against the reference: the mean and the largest step of
    the codes where either side is live."""
    total = live = step = 0
    for u, got in outputs.items():
        want = data.reference_codes(u)
        got = got.to(want.device)
        if got.dtype.is_floating_point:
            got = lna_codes(got)
        if got.shape != want.shape:
            raise ValueError(f"utterance {u}: codes {tuple(got.shape)}, "
                             f"reference {tuple(want.shape)}")
        d, s, n = code_gap(got, want)
        total, live, step = total + d, live + n, max(step, s)
    return [("lna_mean_step", total / max(live, 1)),
            ("lna_max_step", float(step))]


def wer_check(data: AsrData, hyps: dict, last_open: bool = False) -> list:
    """% word errors of ``hyps`` against the planted words; with
    ``last_open`` the planted words but the last, which a decoder that
    does not require the sentence end leaves uncommitted at the end."""
    truth = [data.truth[u][:-1] if last_open else data.truth[u]
             for u in hyps]
    errs, total = word_errors([hyps[u] for u in hyps], truth)
    return [("wer_pct", 100.0 * errs / max(total, 1))]


def _sample(rng, pool: list, n: int, lengths) -> list:
    """``n`` of ``pool`` drawn by ``rng``, the longest among them."""
    pool = list(pool)
    longest = max(pool, key=lambda u: lengths[u])
    rest = [u for u in pool if u != longest]
    pick = rng.choice(len(rest), min(n - 1, len(rest)), replace=False)
    return sorted([longest] + [rest[i] for i in pick])


def build_toolbox(data: AsrData, wl: dict, device):
    """The `Toolbox` of the workload file's ``search`` keys.  An optional
    ``word_boundary`` (a morph LM's ``<w>``) is set before the lexicon is
    read, with silences as words, as `recognize` sets both for a morph
    LM."""
    from aaltoasr_tpu_torch.decoder.toolbox import Toolbox
    s = wl["search"]
    t = Toolbox(data.paths["ph"], data.paths["dur"], device=device)
    t.set_optional_short_silence(s["optional_short_silence"])
    t.set_require_sentence_end(s["require_sentence_end"])
    if "word_boundary" in s:
        t.set_silence_is_word(True)
        t.set_word_boundary(s["word_boundary"])
    t.lex_read(data.paths["lexicon"])
    t.ngram_read(data.paths["lm"])
    t.set_global_beam(s["beam"])
    t.set_token_limit(s["tokens"])
    t.set_lm_scale(s["lm_scale"])
    t.set_duration_scale(s["duration_scale"])
    t.config.num_records = s["records"]
    return t


def phone_probs(data: AsrData, device):
    from aaltoasr_tpu_torch.models.phone_probs import PhoneProbs
    return PhoneProbs(data.paths["am"], data.paths["cfg"], lna_bytes=2,
                      fused=device.type == "cuda", device=device)


class Cell:
    """Shared run state: ``attempted``, ``failed``, ``work`` (the
    counts the metric readers take), and the outputs kept for the
    check: ``hyps`` (words) and ``lp`` (log-probs or codes) by
    utterance."""

    def __init__(self, cfg, wl, seed, device, workdir, task=None):
        self.wl, self.device = wl, device
        self.laps = Laps()
        self.data = AsrData(cfg, wl, seed, device, workdir, self.laps, task)
        self.pp = phone_probs(self.data, device)
        self.scorer = self.pp.fused_scorer or self.pp.scorer
        self.attempted = 0
        self.failed = 0
        counts = ("frames", "k1_rows", "k2_rows", "decode_frames")
        self.work = {"audio_s": 0.0, "states": self.data.task["num_states"],
                     "components": cfg["model"]["components"],
                     "dim": cfg["model"]["dim"],
                     "gaussians": self.data.comp.size,
                     **{k: 0 for k in counts},
                     "profiled": {k: 0 for k in counts}}
        self.hyps: dict = {}
        self.lp: dict = {}
        self.rng = np.random.default_rng([seed, 4])

    def count(self, key: str, n: int, profiled: bool) -> None:
        self.work[key] += n
        if profiled:
            self.work["profiled"][key] += n

    def control(self) -> list:
        """The reference in float32 with TF32 products in the program's
        place, on the same utterances: its LNA numbers and, where the
        cell decodes, the words of its log-probs through the program's
        own search.  Call before `release`."""
        lp = {u: self.data.reference_log_probs(u, torch.float32)
              for u in self.lp}
        out = code_checks(self.data, lp)
        if hasattr(self, "decode"):
            out += self.words_check(self.decode(lp))
        return out

    def words_check(self, hyps: dict) -> list:
        return wer_check(self.data, hyps)

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        for name in ("pp", "scorer", "search", "toolbox", "stream"):
            self.__dict__.pop(name, None)
        self.lp = {u: v.cpu() for u, v in self.lp.items()}
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


class Dense(Cell):
    """Closed loop of batches of ``batch`` utterances, back to back."""

    def __init__(self, cfg, wl, seed, device, workdir, task=None):
        super().__init__(cfg, wl, seed, device, workdir, task)
        from aaltoasr_tpu_torch.decoder.search_dense import DenseBeamSearch
        self.toolbox = build_toolbox(self.data, wl, device)
        t = self.toolbox
        self.search = DenseBeamSearch(t.tree, t.lm, t.model, t.config,
                                      device=device)
        self.laps.lap("program")
        B = wl["batch"]
        U = len(self.data.plans)
        self.batches = []
        for lo in range(0, U - B + 1, B):
            ids = list(range(lo, lo + B))
            n = int(max(self.data.num_samples[u] for u in ids))
            self.batches.append((ids, self.data.samples[lo:lo + B, :n]
                                 .contiguous()))
        # the checked utterances of the first two batches of the window
        self.checked = {j: _sample(self.rng, self.batches[j][0],
                                   wl["check_utterances"], self.data.lengths)
                        for j in range(min(2, len(self.batches)))}
        # warm-up: the batch's frontend and scoring, a short decode
        ids, first = self.batches[0]
        lp = self.scorer.lna_log_probs(self.pp.fg.features_batch(
            first, self.data.num_samples[ids]))
        warm = wl["warm_frames"]
        self.search.decode_batch(lp[:, :warm], np.full(len(ids), warm),
                                 lattice=False)
        sync(device)
        self.laps.lap("warm-up")

    def run(self, window, spans, profiler) -> None:
        fg = self.pp.fg
        j = 0
        while window.open():
            ids, samples = self.batches[j % len(self.batches)]
            profiled = profiler.step(j)
            n_frames = self.data.lengths[ids]
            self.attempted += len(ids)
            with spans("frontend"):
                feats = fg.features_batch(samples,
                                          self.data.num_samples[ids])
            with spans("scoring"):
                lp = self.scorer.lna_log_probs(feats)
            if j in self.checked:
                rows = [ids.index(u) for u in self.checked[j]]
                keep = lp[rows].clone()
            with spans("dense"):
                res = self.search.decode_batch(lp, n_frames, lattice=False)
            window.ended()
            self.failed += len(ids) - len(res)
            for u, r in zip(ids, res):
                self.hyps.setdefault(u, r.words)
            if j in self.checked:
                for i, u in enumerate(self.checked[j]):
                    self.lp[u] = keep[i, :self.data.lengths[u]]
            T_pad = feats.shape[1]
            self.work["audio_s"] += sum(self.data.audio_s(u) for u in ids)
            self.count("frames", int(n_frames.sum()), profiled)
            self.count("k1_rows", len(ids) * T_pad, profiled)
            self.count("k2_rows", len(ids) * (T_pad + 2 * ref_fe.CONTEXT),
                       profiled)
            self.count("decode_frames", len(ids) * T_pad, profiled)
            j += 1
            profiler.after(j)

    def end_to_end(self, window) -> dict:
        return {"xrt": self.work["audio_s"] / window.wall_s}

    def decode(self, lp: dict) -> dict:
        """Words of the log-probs ``lp`` ({u: [T, S]}) through the
        program's dense search, as one batch."""
        ids = sorted(lp)
        T = max(lp[u].shape[0] for u in ids)
        obs = torch.zeros((len(ids), T, lp[ids[0]].shape[1]),
                          device=self.device)
        for i, u in enumerate(ids):
            obs[i, :lp[u].shape[0]] = lp[u].float()
        res = self.search.decode_batch(obs, self.data.lengths[ids],
                                       lattice=False)
        return {u: r.words for u, r in zip(ids, res)}

    def check(self) -> list:
        return code_checks(self.data, self.lp) + self.words_check(self.hyps)


class Stream(Cell):
    """One live session: blocks of ``block_frames`` frames of audio,
    each handed over when the previous block's partial returns.  The
    unit is the utterance: one started in the window streams to its
    end."""

    def __init__(self, cfg, wl, seed, device, workdir):
        super().__init__(cfg, wl, seed, device, workdir)
        d = self.data
        self.host = [d.samples[u, :d.num_samples[u]].cpu().numpy()
                     for u in range(len(d.plans))]
        self.toolbox = build_toolbox(d, wl, device)
        self.stream = self.toolbox.use_one_frame_acoustics()
        self.laps.lap("program")
        self.block_s: list = []
        # warm-up: the first blocks of an utterance, its result, a reset
        self._utterance(self.host[0][:wl["warm_samples"]], None, None, None)
        sync(device)
        self.laps.lap("warm-up")

    def _utterance(self, samples, window, spans, profiler):
        """Stream one utterance -> (final words, its blocks' log-probs)."""
        wl = self.wl
        fg = self.pp.fg
        B = wl["block_frames"]
        chunk = B * ref_fe.HOP
        buf = np.zeros(0, dtype=np.float32)
        done = pos = 0
        lps = []
        sp = spans or (lambda name: contextlib.nullcontext())
        while pos < len(samples):
            t_hand = time.perf_counter()
            buf = np.concatenate([buf, samples[pos:pos + chunk]])
            pos += chunk
            nf = fg.num_frames(len(buf))
            upto = nf if pos >= len(samples) else max(nf - wl["lookahead"], 0)
            while done < upto:
                hi = min(done + B, upto)
                n = len(self.block_s)
                profiled = profiler is not None and profiler.step(n)
                with sp("block_lna"):
                    lp = self.scorer.lna_log_probs(
                        fg.features_range(buf, done, hi))
                with sp("push"):
                    self.stream.push_frames(lp)
                with sp("partial"):
                    self.stream.partial()
                lps.append(lp)
                if window is not None:
                    self.block_s.append(window.ended() - t_hand)
                    self.attempted += 1
                    self.count("frames", hi - done, profiled)
                    profiler.after(n + 1)
                done = hi
        words = self.stream.result().words
        self.stream.reset()
        return words, lps

    def run(self, window, spans, profiler) -> None:
        U = len(self.host)
        j = 0
        while window.open():
            u = j % U
            out = self._utterance(self.host[u], window, spans, profiler)
            if j < U:
                self.hyps[u] = out[0]
                self.lp[u] = torch.cat(out[1])
            self.work["audio_s"] += self.data.audio_s(u)
            j += 1

    def end_to_end(self, window) -> dict:
        return {"block_ms_p90": 1e3 * p90(self.block_s)}

    def decode(self, lp: dict) -> dict:
        """Final words of the log-probs ``lp`` ({u: [T, S]}) through the
        stream's own search, one utterance at a time."""
        out = {}
        for u, v in lp.items():
            self.stream.push_frames(v.float())
            out[u] = self.stream.result().words
            self.stream.reset()
        return out

    def words_check(self, hyps: dict) -> list:
        return wer_check(self.data, hyps,
                         last_open=not self.wl["search"]["require_sentence_end"])

    def check(self) -> list:
        return code_checks(self.data, self.lp) + self.words_check(self.hyps)
