"""PyTorch port, discriminative training: the MPE expectation-semiring
forward-backwards (frame and segment modes), `mpe_stats`/`mpe_stats_seg`,
the host accuracy tables, `EStepDriver.run_recipe` with ``use_hmmnet``,
``mmi`` and every ``errmode``, the EBW pipeline and the `opt_ebw_d`
host copy, each against the JAX package on the same numpy inputs (CPU).

Tolerances: statistics at `tests/test_torch_train.py`'s `_stats_close`
(2e-5 of scale, moment sums 1e-4, feature counts identical); gamma and
gamma_mpe atol 2e-4 (its FB tolerance); totals and average accuracies
rel 1e-5 (abs 1e-4 near zero); host tables, segments, paths and D files
identical.  The driver runs on the same features on both sides (the
`same_features` fixture) and is held to the tolerances the JAX package
holds its per-utterance E-step to (`_stats_dumps_close`, golden=False),
per buffer."""

import math
import wave

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aaltoasr_tpu.formats import model_io as j_mio
from aaltoasr_tpu.formats.fst import Fst, FstArc, write_fst
from aaltoasr_tpu.formats.recipe import Recipe as JRecipe
from aaltoasr_tpu.models import hmm as j_hmm
from aaltoasr_tpu.models import hmmnet as j_net
from aaltoasr_tpu.ops.gmm import GmmScorer as JScorer
from aaltoasr_tpu.train import accumulators as j_acc
from aaltoasr_tpu.train import driver as j_driver
from aaltoasr_tpu.train import estep as j_estep
from aaltoasr_tpu.train import mpe as j_mpe
from aaltoasr_tpu.train import opt_ebw_d as j_od

from aaltoasr_tpu_torch import convert
from aaltoasr_tpu_torch.formats.recipe import Recipe as TRecipe
from aaltoasr_tpu_torch.models import hmm as t_hmm
from aaltoasr_tpu_torch.ops.gmm import GmmScorer
from aaltoasr_tpu_torch.train import accumulators as t_acc
from aaltoasr_tpu_torch.train import driver as t_driver
from aaltoasr_tpu_torch.train import ebw as t_ebw
from aaltoasr_tpu_torch.train import estep as t_estep
from aaltoasr_tpu_torch.train import mpe as t_mpe
from aaltoasr_tpu_torch.train import opt_ebw_d as t_od

from tests.test_mpe_modes import tiny_task
from tests.test_opt_ebw_d import make_stats
from tests.test_torch_train import (
    _close_scaled, _jbatch, _jg, _n, _np, _stats_close, _tg)
from tests.test_torch_train_cli import same_features  # noqa: F401
from tests.test_train import three_state_model
from tests.test_train_cli import CFG

torch.set_num_threads(1)


def _graph(jm, table, labels, pad=0, fan=4, shift=False, **kw):
    fst = j_net.transcript_hmmnet(jm, table, list(labels), **kw)
    g, emit = j_net.compile_hmmnet(fst, table)
    g = j_net.pad_hmmnet(g, int(g["num_positions"]) + pad, fan=fan)
    g["phone"] = np.asarray(
        [[p.label for p in jm.phones].index(fst.arcs[a].label)
         for a in emit] + [0] * pad, np.int32)
    return j_estep.shift_compile(g) if shift else g


def _den_graph(jm, table, pad=4):
    fst = j_net.union_fst(j_net.transcript_hmmnet(jm, table, ["a", "_"]),
                          j_net.transcript_hmmnet(jm, table, ["_", "a"]))
    g, emit = j_net.compile_hmmnet(fst, table)
    P = int(g["num_positions"])
    g = j_net.pad_hmmnet(g, P + pad, fan=6)
    g["phone"] = np.asarray(
        [[p.label for p in jm.phones].index(fst.arcs[a].label)
         for a in emit] + [0] * pad, np.int32)
    return g


@pytest.fixture
def reference_weights(monkeypatch):
    """The MPE FBs with the reference's dead-arc weights (exp(0) = 1
    into dead states, exp(-80) into live ones) instead of the port's 0
    (`train/mpe._live_w`, ROADMAP Queue 3): the parity tests hold the
    port's recursions to the reference's numbers, which those weights
    move by their leak."""
    monkeypatch.setattr(t_mpe, "_live_w", t_mpe._exp_w)


def _acc_close(t, j, name=""):
    assert float(t) == pytest.approx(float(j), rel=1e-5, abs=1e-4), name


def _seg_stats_close(t, j, X, name=""):
    """Statistics of the segment modes' gamma_mpe, whose terms cancel
    (A + B - average): at gamma_mpe's own atol 2e-4, times the features'
    largest magnitude (first moments) and its square (second); matching
    infinities (the reference's D=1 overflow) equal; feature counts
    identical."""
    xmax = float(np.abs(X).max())
    for k in j:
        a, b = np.asarray(j[k], np.float64), np.asarray(t[k], np.float64)
        if k == "feacount":
            np.testing.assert_array_equal(b, a, err_msg=f"{name} {k}")
            continue
        scale = {"mean_acc": xmax, "sec_acc": xmax ** 2}.get(k, 1.0)
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=2e-4 * scale,
                                   err_msg=f"{name} {k}")


# -- the frame-mode FB and statistics ---------------------------------------------

@pytest.mark.parametrize("const", [False, True])
def test_mpe_forward_backward_matches_reference(reference_weights, const):
    """Two utterances of different lengths in one batch, random or
    constant local accuracies: gamma and gamma_mpe atol 2e-4, totals
    and average accuracies rel 1e-5."""
    jm = three_state_model(seed=7)
    table = j_hmm.TransitionTable.from_model(jm)
    g = _den_graph(jm, table)
    rng = np.random.default_rng(8)
    P = g["pdf"].shape[0]
    obs = (rng.normal(-3, 1.5, (2, 10, P)).astype(np.float32)
           + g["obs_const"][None, None])
    acc = (np.ones((2, 10, P), np.float32) if const else
           rng.integers(0, 2, (2, 10, P)).astype(np.float32))
    ns = (10, 6)
    got = t_mpe.mpe_forward_backward(torch.as_tensor(obs), _tg(g, g),
                                     _n(*ns), torch.as_tensor(acc))
    for b, n in enumerate(ns):
        want = j_mpe.mpe_forward_backward(jnp.asarray(obs[b]), _jg(g),
                                          jnp.int32(n), jnp.asarray(acc[b]))
        for k in (0, 1):
            np.testing.assert_allclose(_np(got[k][b]), np.asarray(want[k]),
                                       atol=2e-4)
        for k in (2, 3):
            _acc_close(got[k][b], want[k])
    if const:
        # constant accuracy: every path equally right, gamma_mpe ~ 0
        assert float(got[1].abs().max()) < 1e-3
        assert float(got[3][0]) == pytest.approx(10, rel=1e-4)


@pytest.mark.parametrize("mode,shift", [
    ("mpfe-pdf", False), ("mpfe-pdf", True), ("mpfe-cps", True),
    ("mpfe", True)])
def test_mpe_stats_frame_modes_match_reference(reference_weights, mode,
                                               shift):
    """mpe_stats in each frame mode on a batch of two: the numerator
    Viterbi (plain or shift-compiled), the accuracies and the num/den
    statistics."""
    jm = three_state_model(seed=21, D=5)
    table = j_hmm.TransitionTable.from_model(jm)
    num = _graph(jm, table, ["a", "_"], pad=2, shift=shift)
    den = _den_graph(jm, table)
    js = JScorer.from_model(jm)
    M = j_mpe.phone_membership(jm)
    X = np.random.default_rng(1).normal(0, 2, (2, 24, 5)).astype(np.float32)
    ns = (24, 17)
    got = t_mpe.mpe_stats(convert.gmm_scorer(js), torch.as_tensor(X),
                          _tg(num, num), _tg(den, den), _n(*ns),
                          table.num_slots, mode=mode,
                          membership=torch.as_tensor(M))
    for b, n in enumerate(ns):
        want = j_mpe.mpe_stats(js, jnp.asarray(X[b]), _jg(num), _jg(den),
                               jnp.int32(n), table.num_slots, mode=mode,
                               membership=jnp.asarray(M))
        for part in ("num", "den"):
            _stats_close({k: _np(v[b]) for k, v in got[part].items()},
                         want[part], f"{mode} {part} {b}")
        _acc_close(got["log_likelihood"][b], want["log_likelihood"])
        _acc_close(got["avg_accuracy"][b], want["avg_accuracy"])


def test_mpe_oracles_through_the_port():
    """`tests/test_mpe.py` through the port: a single-path lattice has
    no gradient; a wrong-phone alternative takes the denominator mass."""
    model = three_state_model()
    model.transitions = {s: [(1, 1.0)] for s in range(3)}
    tm = convert.hmm_model(model)
    table = t_hmm.TransitionTable.from_model(tm)
    g = _tg(_graph(model, j_hmm.TransitionTable.from_model(model),
                   ["a", "_"], optional_silence=""))
    X = torch.as_tensor(np.random.default_rng(0).normal(
        0, 1, (1, 3, model.dim)).astype(np.float32))
    out = t_mpe.mpe_stats(GmmScorer.from_model(tm, device="cpu"), X, g, g,
                          _n(3), table.num_slots)
    assert float(out["avg_accuracy"][0]) == pytest.approx(3, abs=1e-3)
    assert float(out["num"]["gamma"].sum()) < 1e-4
    assert float(out["den"]["gamma"].sum()) < 1e-4

    model = three_state_model(seed=5)
    tm = convert.hmm_model(model)
    jt = j_hmm.TransitionTable.from_model(model)
    num_g = _graph(model, jt, ["a"], pad=6 - 4, optional_silence="")
    den = Fst()
    for s, t, slot in ((0, 1, 0), (1, 1, 0), (1, 2, 1), (2, 2, 2),
                       (2, 3, 3), (0, 4, 4), (4, 4, 4), (4, 3, 5)):
        den.add_arc(FstArc(s, t, slot))
    den.initial, den.final = 0, 3
    dg, _ = j_net.compile_hmmnet(den, jt)
    dg = j_net.pad_hmmnet(dg, 8, 4)
    rng = np.random.default_rng(6)
    X = np.zeros((1, 8, model.dim), np.float32)
    sil_mu = model.means[model.mixtures[2][0][0]]
    for t, s in enumerate([0] * 4 + [1] * 4):
        idx, w = model.mixtures[s]
        mu = 0.6 * model.means[idx[rng.choice(len(idx), p=w)]] + 0.4 * sil_mu
        X[0, t] = mu + rng.normal(0, 1.5, model.dim)
    out = t_mpe.mpe_stats(GmmScorer.from_model(tm, device="cpu"),
                          torch.as_tensor(X), _tg(num_g), _tg(dg), _n(8),
                          jt.num_slots)
    num_occ, den_occ = _np(out["num"]["gamma"][0]), _np(out["den"]["gamma"][0])
    assert num_occ[:4].sum() > num_occ[4:6].sum()
    assert den_occ[4:6].sum() > den_occ[:4].sum()


def test_frame_mode_helpers_identical():
    """phone_membership, extract_center_phone and frame_accuracy."""
    jm = three_state_model()
    M = t_mpe.phone_membership(convert.hmm_model(jm))
    np.testing.assert_array_equal(M, j_mpe.phone_membership(jm))
    for lbl in ("a-b+c", "b+c", "a-b", "b", "a-b;x", "-+", "x-;y"):
        assert t_mpe.extract_center_phone(lbl) == j_mpe.extract_center_phone(
            lbl)
    hyp_pdf, hyp_phone = np.array([0, 1, 2]), np.array([0, 0, 1])
    ref_pdf, ref_phone = np.array([0, 2, 1]), np.array([0, 1, 0])
    for mode in ("mpfe-pdf", "mpfe-cps", "mpfe"):
        want = j_mpe.frame_accuracy(
            mode, jnp.asarray(hyp_pdf), jnp.asarray(hyp_phone),
            jnp.asarray(ref_pdf), jnp.asarray(ref_phone), M)
        got = t_mpe.frame_accuracy(
            mode, torch.as_tensor(hyp_pdf)[None],
            torch.as_tensor(hyp_phone)[None], torch.as_tensor(ref_pdf)[None],
            torch.as_tensor(ref_phone)[None], torch.as_tensor(M))
        np.testing.assert_array_equal(_np(got[0]), np.asarray(want))
    with pytest.raises(ValueError, match="unknown"):
        t_mpe.frame_accuracy("mpfe-x", torch.zeros(1, 1), None, None, None, M)


# -- the segment modes ----------------------------------------------------------

@pytest.mark.parametrize("mode", ["mpe", "snfe", "mwe"])
@pytest.mark.parametrize("pad", [0, 3])
def test_segment_tables_identical(mode, pad):
    """segment_accuracy_table (float64, then float32; padded rows copy
    row n_frames) and ref_segments_from_path."""
    rng = np.random.default_rng(4)
    path = np.sort(rng.integers(0, 9, 14))
    inst = np.array([0, 0, 1, 1, 2, 2, 3, 4, 4])
    cls = np.array([0, 0, 1, 1, 0, 0, 2, 1, 1])
    segs = t_mpe.ref_segments_from_path(path, inst, cls, 12)
    assert segs == j_mpe.ref_segments_from_path(path, inst, cls, 12)
    for D in (1, 4, 16):
        for C in (3, 40):         # every class named; most classes not
            np.testing.assert_array_equal(
                t_mpe.segment_accuracy_table(mode, segs, 12, D, C,
                                             pad_frames=12 + pad),
                j_mpe.segment_accuracy_table(mode, segs, 12, D, C,
                                             pad_frames=12 + pad))


@pytest.mark.parametrize("mode,D", [("mpe", 8), ("snfe", 8), ("mwe", 8),
                                    ("snfe", 2), ("mpe", 3)])
def test_mpe_forward_backward_seg_matches_reference(reference_weights, mode,
                                                   D):
    """The duration-augmented FB over `tests/test_mpe_modes.py`'s tiny
    task, two utterances of different lengths padded to one frame count
    (tables built as the driver builds them), with durations that
    saturate (D < the segments): gamma and gamma_mpe atol 2e-4, totals
    and average accuracies rel 1e-5; mpe_stats_seg's statistics at
    gamma_mpe's tolerance (`_seg_stats_close`)."""
    jm, jt, graph, cls, C = tiny_task(seed=1)
    g = dict(graph)
    if mode == "mwe":                       # word classes and instances
        g["inst"] = (np.asarray(g["inst"]) // 2).astype(np.int32)
    P = int(g["num_positions"])
    T = 9
    rng = np.random.default_rng(2)
    obs = (rng.normal(-2, 1.0, (2, T, P)).astype(np.float32)
           + g["obs_const"][None, None])
    ns = (9, 7)
    ref = [[(0, 3, 0), (3, 5, 1), (5, 9, 0)], [(0, 4, 1), (4, 7, 0)]]
    tables = np.stack([j_mpe.segment_accuracy_table(
        mode, ref[b], ns[b], D, C, pad_frames=T) for b in range(2)])
    got = t_mpe.mpe_forward_backward_seg(
        torch.as_tensor(obs), _tg(g, g), _n(*ns), torch.as_tensor(tables),
        torch.as_tensor(np.stack([cls, cls]).astype(np.int64)), D)
    for b, n in enumerate(ns):
        want = j_mpe.mpe_forward_backward_seg(
            jnp.asarray(obs[b]), _jg(g), jnp.int32(n),
            jnp.asarray(tables[b]), jnp.asarray(cls), D)
        for k in (0, 1):
            np.testing.assert_allclose(_np(got[k][b]), np.asarray(want[k]),
                                       atol=2e-4)
        for k in (2, 3):
            _acc_close(got[k][b], want[k], f"{mode} {k}")
    if D >= T:
        np.testing.assert_allclose(_np(got[0][0]).sum(1), np.ones(T),
                                   atol=1e-3)
    # mpe_stats_seg on features, a padded frame past the second's end
    model = convert.hmm_model(jm)
    js = JScorer.from_model(jm)
    X = rng.normal(0, 2, (2, T, jm.dim)).astype(np.float32)
    out = t_mpe.mpe_stats_seg(
        convert.gmm_scorer(js), torch.as_tensor(X), None, _tg(g, g),
        _n(*ns), jt.num_slots, torch.as_tensor(tables),
        torch.as_tensor(np.stack([cls, cls]).astype(np.int64)), D)
    for b, n in enumerate(ns):
        want = j_mpe.mpe_stats_seg(js, jnp.asarray(X[b]), None, _jg(g),
                                   jnp.int32(n), jt.num_slots,
                                   jnp.asarray(tables[b]), jnp.asarray(cls),
                                   D)
        for part in ("num", "den"):
            _seg_stats_close({k: _np(v[b]) for k, v in out[part].items()},
                             want[part], X, f"{mode} {part} {b}")
    assert model.num_states == 3


def _seg_fb(T, D, seed=1):
    """The segment FB of the tiny task, T frames, cap D, through both
    packages: (reference outputs, port outputs)."""
    jm, jt, g, cls, C = tiny_task(seed=seed)
    P = int(g["num_positions"])
    obs = (np.random.default_rng(2).normal(-2, 1.0, (T, P)).astype(
        np.float32) + g["obs_const"][None])
    ref = [(0, T // 3, 0), (T // 3, 2 * T // 3, 1), (2 * T // 3, T, 0)]
    acc = j_mpe.segment_accuracy_table("mpe", ref, T, D, C)
    want = j_mpe.mpe_forward_backward_seg(jnp.asarray(obs), _jg(g),
                                          jnp.int32(T), jnp.asarray(acc),
                                          jnp.asarray(cls), D)
    got = t_mpe.mpe_forward_backward_seg(
        torch.as_tensor(obs)[None], _tg(g), _n(T),
        torch.as_tensor(acc)[None],
        torch.as_tensor(cls.astype(np.int64))[None], D)
    return [np.asarray(w) for w in want], [_np(x[0]) for x in got]


def test_seg_fb_write_order_at_one_frame_cap(reference_weights):
    """D=1 keeps the reference's write order (the overflow slot D-1,
    then slot 0 = the cross-instance commits): gamma, gamma_mpe, total
    and average accuracy as the reference's on 5 frames.  (That order
    drops same-instance arcs from the forward pass and not from the
    backward one, so on longer utterances gamma overflows in both
    packages.)"""
    want, got = _seg_fb(5, 1)
    for k in (0, 1):
        np.testing.assert_allclose(got[k], want[k], atol=2e-4)
    for k in (2, 3):
        _acc_close(got[k], want[k])


def test_seg_fb_dead_states_stay_finite():
    """A long utterance (150 frames, D=8): the reference's unreached
    states carry expected accuracies that grow with the frames (a dead
    arc into a dead state weighs exp(0) = 1) until they overflow and its
    average accuracy is -inf and gamma_mpe non-finite.  The port weighs
    dead arcs 0: its occupancies equal the reference's (atol 2e-4, the
    accuracies do not enter them), its average accuracy lies within the
    range a path can score, and gamma_mpe sums to 0 over each frame's
    positions (E[A + B] = the average, atol 1e-3)."""
    want, got = _seg_fb(150, 8)
    assert not np.isfinite(want[3]) and not np.all(np.isfinite(want[1]))
    assert np.all(np.isfinite(got[1])) and np.isfinite(got[3])
    np.testing.assert_allclose(got[0], want[0], atol=2e-4)
    _acc_close(got[2], want[2])
    # each hypothesis segment scores -1..1, and a path of this
    # left-to-right network has at most one segment per instance
    n_inst = len(np.unique(tiny_task(seed=1)[2]["inst"]))
    assert -n_inst <= float(got[3]) <= n_inst
    np.testing.assert_allclose(got[1].sum(1), 0.0, atol=1e-3)


def test_frame_fb_dead_states_stay_finite():
    """The frame-mode FB on a 120-label network over 150 frames, whose
    far positions stay unreached for most of the utterance: the
    reference's average accuracy and gamma_mpe overflow (as at
    `chip_smoke.py` phase 12's T=1,000); the port's stay finite, its
    occupancies equal the reference's (atol 2e-4), its average accuracy
    lies within 0..T, and gamma_mpe sums to 0 over each frame (within
    1e-4 of T: A + B is up to T, summed in float32 over T steps)."""
    jm = three_state_model(seed=7)
    table = j_hmm.TransitionTable.from_model(jm)
    g = _graph(jm, table, ["a", "_"] * 60)
    T = 150
    P = g["pdf"].shape[0]
    rng = np.random.default_rng(9)
    obs = rng.normal(-3, 1.5, (T, P)).astype(np.float32) + g["obs_const"]
    acc = rng.integers(0, 2, (T, P)).astype(np.float32)
    want = [np.asarray(w) for w in j_mpe.mpe_forward_backward(
        jnp.asarray(obs), _jg(g), jnp.int32(T), jnp.asarray(acc))]
    got = [_np(x[0]) for x in t_mpe.mpe_forward_backward(
        torch.as_tensor(obs)[None], _tg(g), _n(T), torch.as_tensor(acc)[None])]
    assert not (np.isfinite(want[3]) and np.all(np.isfinite(want[1])))
    assert np.all(np.isfinite(got[1])) and 0 <= float(got[3]) <= T
    np.testing.assert_allclose(got[0], want[0], atol=2e-4)
    _acc_close(got[2], want[2])
    np.testing.assert_allclose(got[1].sum(1), 0.0, atol=1e-4 * T)


# -- EStepDriver --------------------------------------------------------------------

def _wav(path, rng, n, freq):
    sig = (2000 * np.sin(2 * np.pi * freq * np.arange(n) / 16000)
           + 200 * rng.standard_normal(n)).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(sig.tobytes())


def hmmnet_corpus(tmp_path, seed=20, n_utts=2, long_num=False):
    """WAVs with numerator (hmmnet=) and denominator (den-hmmnet=)
    networks written by the JAX builders, the model as files (`am`) and
    4-dim features.  ``long_num``: the last utterance's numerator needs
    more frames than it has (no valid path).  Returns the recipe text."""
    rng = np.random.default_rng(seed)
    jm = three_state_model(seed=seed + 1, D=4)
    j_mio.write_model(str(tmp_path / "am"), jm)
    (tmp_path / "feats.cfg").write_text(CFG)
    table = j_hmm.TransitionTable.from_model(jm)
    lines = []
    seqs = [["a", "_"], ["_", "a", "a"], ["a", "_", "a"]]
    for u in range(n_utts):
        _wav(tmp_path / f"u{u}.wav", rng, 4000 + 400 * u, 300 + 150 * u)
        labels = (["a"] * 40 if long_num and u == n_utts - 1
                  else seqs[u % 3])
        write_fst(j_net.transcript_hmmnet(jm, table, labels),
                  str(tmp_path / f"u{u}.num"))
        write_fst(j_net.union_fst(
            j_net.transcript_hmmnet(jm, table, seqs[u % 3]),
            j_net.transcript_hmmnet(jm, table, seqs[(u + 1) % 3])),
            str(tmp_path / f"u{u}.den"))
        (tmp_path / f"u{u}.phn").write_text("\n".join(seqs[u % 3]) + "\n")
        lines.append(f"audio={tmp_path}/u{u}.wav "
                     f"transcript={tmp_path}/u{u}.phn "
                     f"hmmnet={tmp_path}/u{u}.num "
                     f"den-hmmnet={tmp_path}/u{u}.den")
    return "\n".join(lines) + "\n"


def stats_close_all(t, j):
    """Every buffer of two HmmStats within the tolerances the JAX package
    holds its per-utterance E-step to (`_stats_dumps_close`,
    golden=False); the likelihoods and MPE score rel 1e-4.  Feature
    counts identical, in the MPE buffers for each Gaussian whose
    occupancy there passes the occupancy tolerance (1e-3): below it
    gamma_mpe may be the float32 noise of A + B - average (a lattice
    whose paths all score the same accuracy), and its count of
    responsibilities above 1e-10 then counts that noise, differently in
    each summation order."""
    assert sorted(t.buffers) == sorted(j.buffers)
    for b in j.buffers:
        tb, jb = t.buffers[b], j.buffers[b]
        for name in ("gamma", "mix_gamma"):
            np.testing.assert_allclose(getattr(tb, name), getattr(jb, name),
                                       rtol=2e-3, atol=1e-3, err_msg=name)
        for name in ("mean_acc", "sec_acc"):
            np.testing.assert_allclose(getattr(tb, name), getattr(jb, name),
                                       rtol=5e-3, atol=0.05, err_msg=name)
        held = (np.ones_like(jb.gamma, bool)
                if b in (j_acc.ML_BUF, j_acc.MMI_BUF) else jb.gamma > 1e-3)
        np.testing.assert_array_equal(tb.feacount[held], jb.feacount[held])
    np.testing.assert_allclose(t.trans_acc, j.trans_acc, rtol=2e-3, atol=2e-3)
    for k in ("num_ll", "den_ll", "mpe_score"):
        assert getattr(t, k) == pytest.approx(getattr(j, k), rel=1e-4,
                                              abs=1e-4), k
    assert t.num_frames == j.num_frames


def _drivers(tmp_path, mode="bw"):
    jm = j_mio.read_model(str(tmp_path / "am"))
    cfg = str(tmp_path / "feats.cfg")
    # frames padded to 32, not the default 256: the utterances have ~30
    return (j_driver.EStepDriver(jm, cfg, mode=mode, time_bucket=32),
            t_driver.EStepDriver(convert.hmm_model(jm), cfg, mode=mode,
                                 time_bucket=32, device="cpu"))


@pytest.mark.parametrize("kw,mode", [
    (dict(use_hmmnet=True), "bw"), (dict(use_hmmnet=True, mmi=True), "mpv"),
    (dict(use_hmmnet=True, mmi=True, mpe=True, errmode="mpfe-pdf"), "bw"),
    (dict(use_hmmnet=True), "vit")]
    + [(dict(use_hmmnet=True, mpe=True, errmode=e), "bw")
       for e in ("mpe", "snfe", "mpfe-cps", "mpfe")]
    + [(dict(use_hmmnet=True, mpe=True, errmode="mpe", max_seg_dur=3),
        "bw")])
def test_run_recipe_matches_reference(tmp_path, same_features,
                                      reference_weights, kw, mode):
    """`EStepDriver.run_recipe` with -H, --mmi, --mpe in every error mode
    the reference implements (the segment modes also with a duration cap
    the segments pass; with the reference's dead-arc weights), -M mpv:
    every buffer of each utterance on the same features."""
    lines = hmmnet_corpus(tmp_path).splitlines()
    jd, td = _drivers(tmp_path, mode)
    # each utterance on its own; the error modes on the first (each
    # reference call compiles anew)
    for line in (lines if not kw.get("errmode") else lines[:1]):
        want = jd.run_recipe(JRecipe.read([line]), **kw)
        got = td.run_recipe(TRecipe.read([line]), **kw)
        stats_close_all(got, want)
        if kw.get("mmi") or kw.get("mpe"):
            assert not got.trans_acc.any()


def test_run_recipe_refusals_match_reference(tmp_path, same_features):
    """A network with no valid path is skipped and recorded; --mpe
    without den-hmmnet= and --errmode mwe on phone networks raise the
    reference's ValueErrors; --mmi on transcript chains (no -H) fails on
    both sides for the want of the networks' node table (a quirk of the
    reference, kept)."""
    text = hmmnet_corpus(tmp_path, n_utts=2, long_num=True)
    jd, td = _drivers(tmp_path)
    want = jd.run_recipe(JRecipe.read(text.splitlines()), use_hmmnet=True)
    got = td.run_recipe(TRecipe.read(text.splitlines()), use_hmmnet=True)
    assert td.failed_utterances == jd.failed_utterances
    assert len(td.failed_utterances) == 1
    stats_close_all(got, want)
    bare = [ln.split(" den-hmmnet=")[0] for ln in text.splitlines()]
    for d, rec in ((jd, JRecipe), (td, TRecipe)):
        with pytest.raises(ValueError, match="den-hmmnet"):
            d.run_recipe(rec.read(bare), use_hmmnet=True, mpe=True)
        with pytest.raises(ValueError, match="word-level"):
            d.run_recipe(rec.read(text.splitlines()[:1]), use_hmmnet=True,
                         mpe=True, errmode="mwe")
        with pytest.raises(KeyError, match="src_node"):
            d.run_recipe(rec.read(text.splitlines()[:1]), mmi=True)


# -- the EBW pipeline and opt_ebw_d --------------------------------------------------

def test_mmi_objective_improves_through_the_port():
    """`tests/test_ebw.py::test_mmi_objective_improves` on the port's
    E-step and M-step: one EBW step raises num_ll - den_ll."""
    model = convert.hmm_model(three_state_model(seed=20))
    rng = np.random.default_rng(21)
    T = 60
    states = np.concatenate([np.repeat([0, 1], T // 3),
                             np.repeat(2, T - 2 * (T // 3))])
    X = np.zeros((1, T, model.dim), np.float32)
    for t, s in enumerate(states):
        idx, w = model.mixtures[s]
        g = idx[rng.choice(len(idx), p=w)]
        X[0, t] = rng.normal(model.means[g], np.sqrt(model.covars[g]))
    from aaltoasr_tpu_torch.models.hmmnet import (
        compile_hmmnet, pad_hmmnet, transcript_hmmnet)

    def objective(m):
        tb = t_hmm.TransitionTable.from_model(m)
        gn, _ = compile_hmmnet(transcript_hmmnet(m, tb, ["a", "_"],
                                                 optional_silence=""), tb)
        gd, _ = compile_hmmnet(transcript_hmmnet(m, tb, ["_", "a"]), tb)
        pad = max(int(gn["num_positions"]), int(gd["num_positions"]))
        fan = max(gn["in_src"].shape[1], gd["in_src"].shape[1])
        sc = GmmScorer.from_model(m, device="cpu")
        out = [t_driver.fetch(t_estep.chain_stats(
            sc, torch.as_tensor(X), _tg(pad_hmmnet(g, pad, fan)), _n(T),
            tb.num_slots)) for g in (gn, gd)]
        sn, sd = ({k: v[0] for k, v in o.items()} for o in out)
        return (float(sn["log_likelihood"]) - float(sd["log_likelihood"]),
                sn, sd, tb)

    obj0, sn, sd, tb = objective(model)
    mode = t_acc.PDF_ML_STATS | t_acc.PDF_MMI_STATS
    stats = t_acc.HmmStats.zeros(model, tb, mode)
    t_driver.device_stats_to_hmm_stats(model, tb, sn, mode, t_acc.ML_BUF,
                                       stats)
    t_driver.device_stats_to_hmm_stats(model, tb, sd, mode, t_acc.MMI_BUF,
                                       stats)
    assert objective(t_ebw.estimate_mmi(model, tb, stats, minvar=0.01))[
        0] > obj0


@pytest.mark.parametrize("control,train,grad,cluster", [
    ("ml", "ml", False, "none"), ("mmi", "mmi", False, "mix"),
    ("mpe", "mpe", False, "pho"), ("mpe", "mmi", True, "global")])
def test_opt_ebw_d_host_copy_identical(tmp_path, control, train, grad,
                                       cluster):
    """gaussian_clusters, gauss_gradient, combine_gradient,
    gradient_step, qp_step, realize_gaussian_d and the D-file/QP-state
    files: the reference's numbers and bytes."""
    jm = three_state_model(seed=3)
    tm = convert.hmm_model(jm)
    jt = j_hmm.TransitionTable.from_model(jm)
    mode = j_acc.PDF_ML_STATS | j_acc.PDF_MMI_STATS
    if "mpe" in (control, train):
        mode |= j_acc.PDF_MPE_NUM_STATS | j_acc.PDF_MPE_DEN_STATS
    js = []
    for seed in (4, 5):
        s = make_stats(jm, jt, seed=seed)
        full = j_acc.HmmStats.zeros(jm, jt, mode)
        for b in full.buffers:
            src = s.buffers[b % 2 if b in s.buffers else 0]
            for f in ("gamma", "mean_acc", "sec_acc"):
                getattr(full.buffers[b], f)[:] = getattr(src, f) * (1 + b)
        full.num_ll, full.den_ll, full.num_frames = s.num_ll, s.den_ll, 100
        js.append(full)
    ts = [convert.hmm_stats(s) for s in js]
    G = jm.num_gaussians
    cj = j_od.gaussian_clusters(jm, cluster)
    np.testing.assert_array_equal(t_od.gaussian_clusters(tm, cluster), cj)
    d0 = np.linspace(1.0, 4.0, G)
    gj = j_od.gauss_gradient(jm, js[0], js[1], d0, 0.7, control, train, grad)
    np.testing.assert_array_equal(
        t_od.gauss_gradient(tm, ts[0], ts[1], d0, 0.7, control, train, grad),
        gj)
    n_par = int(cj.max()) + 1
    mn, mx = np.full(G, 0.5), np.full(G, 50.0)
    pd, pmn, pmx = j_od.init_cluster_d_from_gaussians(cj, n_par, d0, mn, mx)
    for a, b in zip(t_od.init_cluster_d_from_gaussians(cj, n_par, d0, mn, mx),
                    (pd, pmn, pmx)):
        np.testing.assert_array_equal(a, b)
    args = (gj, cj, pd, d0, mn, mx, pmn, pmx, True, 0.5, 0.1)
    (cg, nd), (tg, tn) = (j_od.combine_gradient(*args),
                          t_od.combine_gradient(*args))
    np.testing.assert_array_equal(tg, cg)
    assert tn == nd
    (d1, st), (td1, tst) = (j_od.gradient_step(pd, cg, pmn, pmx, 0.5),
                            t_od.gradient_step(pd, cg, pmn, pmx, 0.5))
    np.testing.assert_array_equal(td1, d1)
    np.testing.assert_array_equal(tst, st)
    q = j_od.qp_step(d1, cg * 0.5, st, cg, pmn, pmx, 0.02)
    for a, b in zip(t_od.qp_step(d1, cg * 0.5, st, cg, pmn, pmx, 0.02), q):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        t_od.realize_gaussian_d(d1, cj, mn, mx, True, 0.75),
        j_od.realize_gaussian_d(d1, cj, mn, mx, True, 0.75))
    for mod, name in ((j_od, "j"), (t_od, "t")):
        mod.write_d_file(tmp_path / f"{name}.d", d0, mn, mx)
        mod.write_qp_state(tmp_path / f"{name}.qp", st, cg)
    for ext in ("d", "qp"):
        assert (tmp_path / f"t.{ext}").read_bytes() == (
            tmp_path / f"j.{ext}").read_bytes()
    np.testing.assert_array_equal(t_od.read_d_file(tmp_path / "j.d", G)[0],
                                  j_od.read_d_file(tmp_path / "j.d", G)[0])
    assert t_od.read_qp_state(tmp_path / "missing") is None
    assert math.isfinite(float(np.sum(gj)))
