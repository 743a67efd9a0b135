"""The training cell: the `stats -M bw` worker over recipe shards.

Set-up, from the seed: the run's utterance lengths, planted phone
plans and audio, a G-Gaussian model whose states share Gaussians (the
program's `random_model` layout) placed on the audio's reference
features, and for each shard of ``shard`` utterances its WAVs, .phn
transcripts and recipe under the run's temporary directory.  The
program reads the model files (`read_model`) and builds one
`EStepDriver(mode="bw")`.  The window runs the shards in turn through
`run_recipe_batched(recipe, batch_size)`, each to its host `HmmStats`.
Every shard holds the same utterance lengths and chain lengths in
another order (`plan.run_lengths` by shard, `plan.phone_plan`), so
every shard fills the same shape buckets: the same work in every shard
and every seed.

The check reads each utterance's log-likelihood as the driver makes it:
in the kept shards the per-utterance statistics the driver folds into
its `HmmStats` (`device_stats_to_hmm_stats`) pass through a recorder,
which keeps their frame count, log-likelihood and the states they
occupy; the state set and frame count name the utterance.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from portbench.harness import Laps, sync
from portbench.reference import fb
from portbench.reference import frontend as ref_fe
from portbench.reference.gmm import Gmm
from portbench.traffic import audio, files, models, plan
from portbench.traffic.task import chain_task

FRAME_RATE = 125.0


class EStep:
    """Closed loop of shards; the outputs kept for the check are the
    `HmmStats` of the window's first ``check_shards`` shards and their
    utterances' log-likelihoods."""

    def __init__(self, cfg, wl, seed, device, workdir):
        from aaltoasr_tpu_torch.formats.model_io import read_model
        from aaltoasr_tpu_torch.train.driver import EStepDriver
        self.wl, self.device = wl, device
        self.laps = Laps()
        m = cfg["model"]
        self.task = task = chain_task(m["states"])
        self.lengths = plan.run_lengths(wl["lengths"], FRAME_RATE, seed)
        self.plans, self.transcripts = plan.plans(task, self.lengths, seed,
                                                  "phones")
        sig = audio.signatures(m["states"], [], seed)
        samples, self.num_samples = audio.synthesize(self.plans, sig, seed,
                                                     device)
        sync(device)
        self.laps.lap("traffic")
        self.comp, self.weights = models.mixtures(
            m["states"], m["gaussians"], m["components"], True, seed)
        tab = ref_fe.tables(device, torch.float64)
        U = len(self.plans)
        feats = torch.cat([ref_fe.features(samples[u, :self.num_samples[u]],
                                           tab) for u in range(U)])
        states = torch.as_tensor(np.concatenate(self.plans), device=device)
        self.means, self.covars = models.place(self.comp, m["gaussians"],
                                               feats, states, seed)
        del feats
        self.samples = [samples[u, :self.num_samples[u]].cpu().numpy()
                        for u in range(U)]
        del samples
        self.laps.lap("model")
        base = os.path.join(workdir, "am")
        files.write_model(base, task["phones"], task["transitions"],
                          self.means, self.covars, self.comp, self.weights)
        cfg_path = files.write_text(os.path.join(workdir, "feats.cfg"),
                                    cfg["feature_config"])
        n = wl["shard"]
        self.shards = []
        for k in range(U // n):
            ids = list(range(k * n, (k + 1) * n))
            path = files.write_recipe(
                os.path.join(workdir, "corpus"), f"s{k}",
                [self.samples[u] for u in ids],
                [self.transcripts[u] for u in ids])
            self.shards.append((ids, path))
        self.laps.lap("files")
        self.driver = EStepDriver(read_model(base), cfg_path, mode="bw",
                                  device=device)
        self.laps.lap("program")
        self.attempted = 0
        self.failed = 0
        counts = ("frames", "frame_positions")
        self.work = {"gaussians": m["gaussians"], "dim": m["dim"],
                     **{c: 0 for c in counts},
                     "profiled": {c: 0 for c in counts}}
        self.stats: dict = {}
        self.utt_ll: dict = {}          # shard -> {utterance: ll}
        self.checked = set(range(min(wl["check_shards"], len(self.shards))))
        # warm-up: the first shard's ``batch`` longest utterances, the
        # same lengths and chains in every seed
        from aaltoasr_tpu_torch.formats.recipe import Recipe
        ids, path = self.shards[0]
        warm = sorted(ids, key=lambda u: (-int(self.lengths[u]), u))
        with open(path) as f:
            lines = f.readlines()
        self._shard(Recipe.read([lines[u - ids[0]]
                                 for u in sorted(warm[:wl["batch"]])]))
        sync(device)
        self.laps.lap("warm-up")

    def _shard(self, recipe):
        return self.driver.run_recipe_batched(recipe,
                                              batch_size=self.wl["batch"])

    def run(self, window, spans, profiler) -> None:
        from aaltoasr_tpu_torch.formats.recipe import Recipe
        j = 0
        while window.open():
            k = j % len(self.shards)
            ids, path = self.shards[k]
            profiled = profiler.step(j)
            self.attempted += len(ids)
            before = len(self.driver.failed_utterances)
            kept: list = []
            with spans("estep"), self.recorded(kept, j in self.checked):
                stats = self._shard(Recipe.read(path))
            window.ended()
            failed = set(self.driver.failed_utterances[before:])
            self.failed += len(failed)
            done = [u for u in ids
                    if not any(p.endswith(f"s{k}_{u - ids[0]}.wav")
                               for p in failed)]
            frames = int(sum(self.lengths[u] for u in done))
            positions = int(sum(self.lengths[u] * 2 * len(self.transcripts[u])
                                for u in done))
            self.count("frames", frames, profiled)
            self.count("frame_positions", positions, profiled)
            if j in self.checked:
                self.stats[k] = stats
                self.utt_ll[k] = self.name_utterances(ids, kept)
            j += 1
            profiler.after(j)

    @contextlib.contextmanager
    def recorded(self, kept: list, on: bool):
        """While open (and ``on``), each utterance's statistics that the
        driver folds into its total also go to ``kept`` as (frames,
        log-likelihood, occupied states)."""
        if not on:
            yield
            return
        import aaltoasr_tpu_torch.train.driver as drv
        from aaltoasr_tpu_torch.train.accumulators import ML_BUF
        orig = drv.device_stats_to_hmm_stats

        def recorder(*a, **k):
            st = orig(*a, **k)
            occ = st.buffers[ML_BUF].mix_gamma.sum(1)
            kept.append((int(st.num_frames), float(st.num_ll),
                         frozenset(np.flatnonzero(occ > 0.5).tolist())))
            return st
        drv.device_stats_to_hmm_stats = recorder
        try:
            yield
        finally:
            drv.device_stats_to_hmm_stats = orig

    def name_utterances(self, ids: list, kept: list) -> dict:
        """{utterance: log-likelihood} of the recorded statistics whose
        frame count and occupied states are those of exactly one of the
        shard's utterances ``ids``; others are left out."""
        phones = self.task["phones"]
        key = {u: (int(self.lengths[u]),
                   frozenset(s for lbl in self.transcripts[u]
                             for s in phones[lbl])) for u in ids}
        out: dict = {}
        for frames, ll, states in kept:
            match = [u for u in ids if key[u] == (frames, states)]
            if len(match) == 1:
                out.setdefault(match[0], ll)
        return out

    def count(self, key, n, profiled) -> None:
        self.work[key] += n
        if profiled:
            self.work["profiled"][key] += n

    def end_to_end(self, window) -> dict:
        return {"stats_fps": self.work["frames"] / window.wall_s}

    def release(self) -> None:
        self.__dict__.pop("driver", None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, k: int, dtype=torch.float64) -> dict:
        """Shard ``k``'s statistics by the plain reference in ``dtype``
        (float32: TF32 products, the control)."""
        ids = self.shards[k][0]
        tab = ref_fe.tables(self.device, dtype)
        gmm = Gmm(self.means, self.covars, self.comp, self.weights,
                  self.device, dtype)
        feats = [ref_fe.features(torch.as_tensor(self.samples[u],
                                                 device=self.device),
                                 tab, dtype) for u in ids]
        return fb.stats(self.task, gmm, feats,
                        [self.transcripts[u] for u in ids], self.device)

    def check(self) -> list:
        """The program's statistics of the kept shards against the
        reference's."""
        from aaltoasr_tpu_torch.train.accumulators import ML_BUF
        out = {}
        for k, st in self.stats.items():
            buf = st.buffers[ML_BUF]
            out[k] = {"utt_ll": self.utt_ll.get(k, {}),
                      "state_occ": buf.mix_gamma.sum(1),
                      "gauss_occ": buf.gamma, "mean_acc": buf.mean_acc,
                      "sec_acc": buf.sec_acc}
        return self.compare(out)

    def control(self) -> list:
        """The reference in float32 with TF32 products in the program's
        place, on the same shards."""
        out = {}
        for k in self.stats:
            ref = self.reference(k, torch.float32)
            ref["utt_ll"] = dict(zip(self.shards[k][0], ref["utt_ll"]))
            out[k] = ref
        return self.compare(out)

    def compare(self, outputs: dict) -> list:
        """Worst relative gaps over the shards ``outputs`` ({shard:
        statistics}): ``utt_ll_rel``, |got - ref| / |ref| of each
        utterance's log-likelihood (1 where the utterance has none), and
        for each summed statistic ||got - ref|| / ||ref||."""
        worst: dict = {}

        def keep(name, v):
            worst[name] = max(worst.get(name, 0.0), v)
        for k, got in outputs.items():
            ref = self.reference(k)
            for u, r in zip(self.shards[k][0], ref["utt_ll"]):
                g = got["utt_ll"].get(u)
                keep("utt_ll_rel", 1.0 if g is None else
                     abs(float(g) - float(r)) / max(abs(float(r)), 1e-300))
            for key in ("state_occ", "gauss_occ", "mean_acc", "sec_acc"):
                r = np.asarray(ref[key], np.float64)
                g = np.asarray(got[key], np.float64)
                keep(f"{key}_rel", float(np.linalg.norm(g - r))
                     / max(float(np.linalg.norm(r)), 1e-300))
        return list(worst.items())
