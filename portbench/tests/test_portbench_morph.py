"""The morph cell's loop file at a tiny size on the CPU: a run through
`run.main` is correct, its planted faults read beyond its limits, and
the order-3 walk planted in the reference makes ``lm_rel`` fail."""

import copy
import json
import types

import numpy as np
import pytest
import torch

from portbench import program_spans, roofline, run
from portbench.reference import morph_lm
from portbench.traffic.morph import lookup_orders, morph_plan, morph_task

CELL = "fi-morph.dense-b128"


def tiny_spec(morphs: int = 300, order: int = 4) -> tuple:
    """`run.cell_spec` of the morph cell with a ``morphs``-morph task and
    an order-``order`` LM, 4 utterances of 2-3 s in batches of 2."""
    bench, entry, wl, cfg = copy.deepcopy(run.cell_spec(CELL))
    cfg["task"].update(num_morphs=morphs, order=order)
    cfg["ngram_counts"] = {str(n): c for n, c in
                           zip(range(2, order + 1), (3000, 2000, 1000, 500, 250))}
    wl["batch"] = 2
    wl["lengths"].update(count=2, units=2, median_s=2.5, lo_s=2.0, hi_s=3.0)
    wl["check_utterances"] = 2
    return bench, entry, wl, cfg


def result(capsys, spec=None):
    rc = run.main(["--workload", CELL, "--seed", "3000000001", "--seconds",
                   "0.5", "--trace", "0"], device=torch.device("cpu"),
                  spec=spec or tiny_spec())
    assert rc == 0
    cap = capsys.readouterr()
    readings = {ln.split()[1].rstrip(":"): float(ln.split()[2])
                for ln in cap.err.splitlines() if ln.startswith("reading ")}
    return json.loads(cap.out.strip().splitlines()[-1]), readings, cap.err


def test_the_cell_resolves_to_its_loop_file():
    from portbench.loops import asr, morph
    assert run.loop_class("morph") is morph.Morph
    assert issubclass(morph.Morph, asr.Dense)


def test_a_tiny_run_is_correct_and_its_faults_are_not(capsys):
    res, readings, err = result(capsys)
    checks = res["checks"]
    assert res["correct"] is True and res["attempted"] > 0, checks
    assert set(checks) == {"unanswered", "lna_mean_step", "lna_max_step",
                           "morph_er_pct", "lm_rel"}
    limits = run.cell_spec(CELL)[2]["limits"]
    assert (readings["morph_er_pct.first_morph_altered"]
            > limits["morph_er_pct"])
    assert readings["lm_rel.order3"] > limits["lm_rel"]
    assert "LM order 4" in err and "LM lookups hit at order >= 4" in err


def test_the_order3_walk_planted_in_the_reference_fails_lm_rel(capsys,
                                                              monkeypatch):
    orig = morph_lm.log_prob
    monkeypatch.setattr(morph_lm, "log_prob",
                        lambda ng, order, h, w: orig(ng, min(order, 3), h, w))
    res, _, _ = result(capsys)
    assert res["correct"] is False
    c = res["checks"]["lm_rel"]
    assert c["value"] > c["limit"]


def test_the_planted_text_walks_the_lm():
    """A long silence opens each utterance, then units (morphs and
    `<w>`) walked from `<s> <w>`: none follows a boundary with another,
    words have 1-4 morphs, each boundary is a stay in the short silence,
    and most lookups hit at order 4 or more."""
    task = morph_task(num_morphs=300, num_phones=25, seed=0, order=6,
                      ngram_counts={2: 3000, 3: 2000, 4: 1000, 5: 500,
                                    6: 250})
    rng = np.random.default_rng(7)
    sil, long_sil = task["phones"]["_"][0], task["phones"]["__"]
    orders = []
    for T in (250, 600, 900):
        states, said = morph_plan(task, T, rng)
        assert len(states) == T and states[0] == long_sil[0]
        units = [task["words"][w] for w in said]
        assert units[0] != "<w>"
        run_ = 0
        for a, b in zip(units, units[1:]):
            assert not (a == b == "<w>")
            run_ = 0 if b == "<w>" else run_ + 1
            assert run_ <= 4
        gaps = np.diff(np.flatnonzero(np.diff(
            np.r_[0, states == sil, 0].astype(int)) != 0))[::2]
        assert len(gaps) == units.count("<w>")
        orders += lookup_orders(task, units)
    assert sum(o >= 4 for o in orders) > len(orders) / 2


def test_the_silence_between_words_keeps_their_contexts():
    """Across a `<w>` the morphs' boundary phones take the neighbouring
    morphs' phones as their contexts, as the tree's optional short
    silence keeps them."""
    task = morph_task(num_morphs=300, num_phones=25, seed=0, order=4,
                      ngram_counts={2: 3000, 3: 2000, 4: 1000})
    labels, prons = task["phones"], task["prons"]
    wb = len(prons) - 1
    states, said = morph_plan(task, 900, np.random.default_rng(3))
    i = said.index(wb)
    before, after = prons[said[i - 1]], prons[said[i + 1]]
    last = labels[f"{before[-2]}-{before[-1]}+{after[0]}"
                  if len(before) > 1 else
                  f"{prons[said[i - 2]][-1]}-{before[-1]}+{after[0]}"]
    s = list(states)
    k = s.index(task["phones"]["_"][0])
    assert s[k - 1] == last[-1]


@pytest.mark.parametrize("n", [2, 3, 4, 5, 6])
def test_every_gram_has_its_prefix_and_suffix(n):
    task = morph_task(num_morphs=300, num_phones=25, seed=0, order=6,
                      ngram_counts={2: 3000, 3: 2000, 4: 1000, 5: 500,
                                    6: 250})
    grams = task["ngrams"]
    assert len(grams[n]) > 0
    for g in grams[n]:
        assert g[:-1] in grams[n - 1] and g[1:] in grams[n - 1], g


def test_a_lost_boundary_is_a_word_error_but_no_morph_error():
    from portbench.loops.morph import Morph
    m = object.__new__(Morph)
    m.data = types.SimpleNamespace(truth=[
        ["</s>", "<s>", "<w>", "ka", "la", "<w>", "ta", "<w>", "</s>"],
        ["</s>", "<s>", "<w>", "ku", "<w>", "si", "<w>"]])
    m.hyps = {0: ["<s>", "<w>", "ka", "la", "ta", "<w>", "</s>"],
              1: ["<s>", "<w>", "ku", "<w>", "si", "<w>"]}
    assert m._morph_er(m.hyps, altered=False) == 0.0
    assert m._morph_er(m.hyps, altered=True) == pytest.approx(100 * 2 / 5)
    wer, lost = m._words()
    # "kala ta" read "kalata": one substitution and one deletion of 4 words
    assert wer == pytest.approx(100 * 2 / 4)
    assert lost == pytest.approx(100 * 1 / 2)


def view(dev, host, frames=250):
    return run.RunView(None, roofline.Profile(dev, host, 10.0),
                       {"profiled": {"frames": frames}}, 10.0)


def test_the_state_roofline_reads_device_time_inside_the_dense_span(
        monkeypatch):
    read = run.load_reader("dense_state_roofline.xrt")
    dev = [("k", 0.0, 1.0), ("k", 1.5, 2.0), ("Memcpy DtoH", 2.0, 2.1),
           ("k", 5.0, 9.0)]
    host = [("pb:dense", -0.1, 2.5), ("pb:scoring", 4.0, 9.5)]
    monkeypatch.setattr(program_spans, "traced_count",
                        lambda n: 0.3 * roofline.HBM_BYTES_PER_S
                        if n == "dense.state_bytes" else None)
    # 0.3 s of bytes at the bandwidth over 1.5 s of kernels in `dense`
    assert read(view(dev, host)) == pytest.approx(20.0)
    assert read(view([("k", 5.0, 9.0)], host)) is None
    monkeypatch.setattr(program_spans, "traced_count", lambda n: None)
    assert read(view(dev, host)) is None      # a program without it


def test_the_lm_walk_reader_takes_its_span_per_audio_second(monkeypatch):
    read = run.load_reader("dense_lmwalk_ms_per_s.xrt")
    monkeypatch.setattr(program_spans, "span_ns",
                        lambda names, own=False: 4e6
                        if names == ("dense.lmwalk",) else None)
    assert read(view([], [])) == pytest.approx(2.0)   # 4 ms over 2 s
    monkeypatch.setattr(program_spans, "span_ns", lambda names, own=False:
                        None)
    assert read(view([], [])) is None
