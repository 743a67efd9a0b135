"""Finnish morph LVCSR: the dense loop over a morph task.

The configuration's task is `traffic.morph.morph_task` (statistical
morphs, ``<w>`` word boundaries, an order-6 backoff LM), planted by
`traffic.morph.plans` (``<w>`` a short silence transparent to the
cross-word contexts, which `plan.word_plan` cannot plant; `AsrData`
draws its plans through it while a `Morph` is set up); the workload
file sets ``search.word_boundary`` to ``<w>``, so the toolbox is built
as `recognize` builds it for a morph LM (silences as words, ``<w>``
committed by the short silence).  The loop is `Dense`'s: batches
through `features_batch`, `lna_log_probs` and
`DenseBeamSearch.decode_batch(lattice=False)`.

Checks besides `Dense`'s LNA numbers:

- ``morph_er_pct``: % errors of the committed morphs against the planted
  ones, over the morph sequences with ``<w>``, ``<s>``, ``</s>`` and the
  silences taken out;
- ``lm_rel``: over the checked utterances of the first two batches, the
  largest |``final_lms`` - the reference's score of the same units| /
  |the reference's score| (`reference/morph_lm.py`, float64).

Readings beside them, not compared: the same two with a fault planted,
each utterance's first morph altered (``morph_er_pct.first_morph_altered``)
and the reference's walk capped at order 3 (``lm_rel.order3``); the
word errors of the units joined into words by `recognize`'s
`morph_text` (``wer_pct.words``), and the planted word boundaries the
hypotheses lack, net a hypothesis (``wb_lost_pct``).  The dense engine
merges LM histories at a word's first node before the word's LM score,
so it drops a ``<w>`` whose short silence lasts a frame or two: the
words merge while the morphs stay, which the last two show.
"""

from __future__ import annotations

import math
import sys
import types

from aaltoasr_tpu_torch.cli.recognize import morph_text
from portbench.loops import asr
from portbench.loops.asr import Dense
from portbench.reference import morph_lm
from portbench.reference.words import content_words, word_errors
from portbench.traffic import morph
from portbench.traffic.morph import lookup_orders, morph_task


class Morph(Dense):
    """`Dense` over the configuration's morph task."""

    def __init__(self, cfg, wl, seed, device, workdir):
        args = dict(cfg["task"], ngram_counts=cfg["ngram_counts"])
        if "num_words" in args:
            # a rehearsal cut by `tests/tiny.py`, which sizes a task by
            # its words: here its morphs, the LM cut as much
            k = args["num_words"] / args["num_morphs"]
            args["num_morphs"] = args.pop("num_words")
            args["ngram_counts"] = {n: max(1, round(c * k)) for n, c in
                                    args["ngram_counts"].items()}
        units = wl["lengths"]["count"] * wl["lengths"].get("units", 1)
        if wl["batch"] > units:     # fewer utterances than a batch: one
            wl = dict(wl, batch=units)
        task = morph_task(**args)
        self.kept: list = []        # (words, final_lms) of checked batches
        real = asr.plan
        asr.plan = types.SimpleNamespace(
            run_lengths=real.run_lengths,
            plans=lambda task, lengths, seed, kind: morph.plans(
                task, lengths, seed))
        try:
            super().__init__(cfg, wl, seed, device, workdir, task)
        finally:
            asr.plan = real
        print(f"portbench: {self.toolbox.tree.num_nodes} tree nodes, LM "
              f"order {self.toolbox.lm.order}, "
              f"{len(task['words']) - 1} morphs, batch {wl['batch']}",
              file=sys.stderr)
        for j in sorted(self.checked):
            orders = [o for u in self.batches[j][0]
                      for o in lookup_orders(task, self.data.truth[u])]
            share = sum(o >= 4 for o in orders) / max(len(orders), 1)
            print(f"portbench: checked batch {j}: {100 * share:.1f}% of the "
                  f"planted text's {len(orders)} LM lookups hit at order "
                  ">= 4", file=sys.stderr)

    def run(self, window, spans, profiler) -> None:
        """`Dense.run`, keeping each unit sequence and ``final_lms`` of the
        first two batches for ``lm_rel``."""
        decode = self.search.decode_batch

        def keep(*args, **kw):
            res = decode(*args, **kw)
            if len(self.kept) < len(self.checked):
                self.kept.append([(r.words, r.final_lms) for r in res])
            return res
        self.search.decode_batch = keep
        try:
            super().run(window, spans, profiler)
        finally:
            del self.search.decode_batch

    def words_check(self, hyps: dict) -> list:
        return [("morph_er_pct", self._morph_er(hyps, altered=False))]

    def _morph_er(self, hyps: dict, altered: bool) -> float:
        said = [morphs(hyps[u]) for u in hyps]
        if altered:
            said = [[m[0] + "a"] + m[1:] if m else ["a"] for m in said]
        errs, total = word_errors(
            said, [morphs(self.data.truth[u]) for u in hyps])
        return 100.0 * errs / max(total, 1)

    def _words(self) -> tuple[float, float]:
        """(``wer_pct.words``, ``wb_lost_pct``) of the window's
        hypotheses."""
        said = [morph_text(self.hyps[u]).split() for u in self.hyps]
        truth = [morph_text(self.data.truth[u]).split() for u in self.hyps]
        errs, total = word_errors(said, truth)
        lost = sum(max(0, len(t) - len(h)) for h, t in zip(said, truth))
        planted = sum(max(0, len(t) - 1) for t in truth)
        return 100.0 * errs / max(total, 1), 100.0 * lost / max(planted, 1)

    def _lm_rel(self, order: int) -> float:
        task = self.data.task
        worst = 0.0 if self.kept else math.inf
        for j, res in enumerate(self.kept):
            ids = self.batches[j % len(self.batches)][0]
            for u in self.checked[j]:
                words, got = res[ids.index(u)]
                want = morph_lm.score(
                    task["ngrams"], task["vocab"], words, order,
                    sentence_end=self.wl["search"]["require_sentence_end"])
                worst = max(worst, morph_lm.relative_gap(got, want))
        return worst

    def check(self) -> list:
        wer, lost = self._words()
        return super().check() + [
            ("lm_rel", self._lm_rel(self.data.task["order"])),
            ("morph_er_pct.first_morph_altered",
             self._morph_er(self.hyps, True)),
            ("lm_rel.order3", self._lm_rel(3)),
            ("wer_pct.words", wer), ("wb_lost_pct", lost)]


def morphs(units) -> list:
    """The morphs of a unit sequence: no boundaries, sentence markers or
    silences."""
    return [w for w in content_words(units) if w != "<w>"]


CELL = Morph
