"""PyTorch port, HMM networks: the MIT-FST reader and writer, the hmmnet
compiler and builders (`compile_hmmnet`, `pad_hmmnet`,
`transcript_hmmnet`, `wordgraph_hmmnet`, `union_fst`), the
multipath-Viterbi forward-backward, the per-arc feature counts of
`chain_stats` and state segmentation, each against the JAX package on
the same numpy inputs (CPU).

Tolerances: FST files, graph tables, realized masks, liveness masks,
Viterbi paths, feature counts and state segments identical; gamma atol
2e-4 and totals rel 1e-5 (`tests/test_torch_train.py`'s FB tolerance);
statistics at `_stats_close`'s (2e-5 of scale, moment sums 1e-4); the
float64 mirror of `tests/test_mpv.py` at its own atol 2e-3."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aaltoasr_tpu.decoder.lexicon import read_lexicon as j_read_lexicon
from aaltoasr_tpu.decoder.stateseg import hypothesis_fst as j_hyp_fst
from aaltoasr_tpu.decoder.stateseg import state_segmentation as j_stateseg
from aaltoasr_tpu.decoder.toolbox import Toolbox as JToolbox
from aaltoasr_tpu.decoder.wordgraph import WGArc as JArc
from aaltoasr_tpu.decoder.wordgraph import WGNode as JNode
from aaltoasr_tpu.decoder.wordgraph import WordGraph as JGraph
from aaltoasr_tpu.formats import fst as j_fst
from aaltoasr_tpu.formats.lna import read_lna
from aaltoasr_tpu.models import hmm as j_hmm
from aaltoasr_tpu.models import hmmnet as j_net
from aaltoasr_tpu.ops.gmm import GmmScorer as JScorer
from aaltoasr_tpu.train import estep as j_estep

from aaltoasr_tpu_torch import convert
from aaltoasr_tpu_torch.decoder.lexicon import read_lexicon as t_read_lexicon
from aaltoasr_tpu_torch.decoder.stateseg import hypothesis_fst as t_hyp_fst
from aaltoasr_tpu_torch.decoder.stateseg import state_segmentation as t_stateseg
from aaltoasr_tpu_torch.decoder.stateseg import write_state_segmentation
from aaltoasr_tpu_torch.decoder.toolbox import Toolbox as TToolbox
from aaltoasr_tpu_torch.decoder.wordgraph import WGArc as TArc
from aaltoasr_tpu_torch.decoder.wordgraph import WGNode as TNode
from aaltoasr_tpu_torch.decoder.wordgraph import WordGraph as TGraph
from aaltoasr_tpu_torch.formats import fst as t_fst
from aaltoasr_tpu_torch.models import hmm as t_hmm
from aaltoasr_tpu_torch.models import hmmnet as t_net
from aaltoasr_tpu_torch.train import estep as t_estep

from tests.test_decoder import make_decode_task
from tests.test_golden_decode import make_task, synth_lna
from tests.test_mpv import np_mpv_fb
from tests.test_torch_train import (
    _jbatch, _jg, _n, _np, _obs, _stats_close, _tg)
from tests.test_train import three_state_model

torch.set_num_threads(1)


def _models(seed=0, D=4):
    jm = three_state_model(seed=seed, D=D)
    return jm, convert.hmm_model(jm)


def _tables(jm, tm):
    return (j_hmm.TransitionTable.from_model(jm),
            t_hmm.TransitionTable.from_model(tm))


def _fst_text(fst_mod, fst) -> str:
    import io
    buf = io.StringIO()
    fst_mod.write_fst(fst, buf)
    return buf.getvalue()


def _same_graph(t, j):
    assert sorted(t) == sorted(j)
    for k in j:
        a, b = np.asarray(j[k]), np.asarray(t[k])
        assert b.dtype == a.dtype, k
        np.testing.assert_array_equal(b, a, err_msg=k)


# -- the MIT-FST format ---------------------------------------------------------

FST_TEXTS = [
    "I 0\nF 3\nT 0 1 5;a ,\nT 1 2 #a\nT 2 3 , , -1.5\n",
    "I 2\nF 0\nT 2 1 3;x y -0.25\nT 1 1 4\nT 1 0 , w\nT 1 0 sym out\n",
    "I 0\nF 1\nT 0 1\nT 0 0 7;q ; 2.5\n",
]


@pytest.mark.parametrize("text", FST_TEXTS)
def test_fst_read_write_identical(tmp_path, text):
    """parse_fst gives the same arcs; write_fst the same bytes, and a
    second round trip is stable."""
    (tmp_path / "in.fst").write_text(text)
    jf = j_fst.read_fst(str(tmp_path / "in.fst"))
    tf = t_fst.read_fst(str(tmp_path / "in.fst"))
    assert [vars(a) for a in tf.arcs] == [vars(a) for a in jf.arcs]
    assert [vars(a) for a in convert.fst(jf).arcs] == [vars(a)
                                                       for a in jf.arcs]
    assert (tf.initial, tf.final, tf.num_nodes) == (jf.initial, jf.final,
                                                    jf.num_nodes)
    j_fst.write_fst(jf, str(tmp_path / "j.fst"))
    t_fst.write_fst(tf, str(tmp_path / "t.fst"))
    assert (tmp_path / "t.fst").read_bytes() == (tmp_path / "j.fst").read_bytes()
    again = t_fst.parse_fst((tmp_path / "t.fst").read_text())
    assert _fst_text(t_fst, again) == _fst_text(j_fst, jf)


@pytest.mark.parametrize("text,err", [
    ("F 1\nT 0 1\n", "initial"), ("I 0\nT 0 1\n", "final"),
    ("#FSTBinary\n", "FSTBinary"), ("I 0\nI 1\nF 1\n", "redefined")])
def test_fst_parse_errors_match(text, err):
    for mod in (j_fst, t_fst):
        with pytest.raises(ValueError, match=err):
            mod.parse_fst(text)


# -- the hmmnet compiler and builders ---------------------------------------------

def _word_graph(mod_graph, mod_node, mod_arc, weak=False):
    g = mod_graph(lm_scale=1.5)
    g.nodes = [mod_node(0, 0), mod_node(1, 3), mod_node(2, 6),
               mod_node(3, 6)]
    g.arcs = [mod_arc(0, 1, "yksi", -10.0, -0.3),
              mod_arc(0, 1, "kaksi", -200.0 if weak else -12.0, -0.9),
              mod_arc(1, 2, "kolme", -11.0, -0.8),
              mod_arc(2, 3, "</s>", 0.0, -0.2),
              mod_arc(1, 2, "_", -3.0, -0.1)]
    g.start_node, g.end_node = 0, 3
    return g


def _networks(kind):
    """(JAX FST, port FST, JAX model, port model) of one builder."""
    if kind.startswith("wordgraph"):
        jm, _, _ = make_decode_task()
        tm = convert.hmm_model(jm)
        jt, tt = _tables(jm, tm)
        lex = "yksi a b\nkaksi b a\nkaksi(0.5) b b\nkolme c a\n_ _\n"
        prune = 0.01 if kind.endswith("prune") else 0.0
        jf = j_net.wordgraph_hmmnet(
            jm, jt, j_read_lexicon(lex), _word_graph(JGraph, JNode, JArc,
                                                    weak=bool(prune)),
            posterior_prune=prune)
        tf = t_net.wordgraph_hmmnet(
            tm, tt, t_read_lexicon(lex), _word_graph(TGraph, TNode, TArc,
                                                    weak=bool(prune)),
            posterior_prune=prune)
        return jf, tf, jm, tm
    jm, tm = _models(seed=3)
    jt, tt = _tables(jm, tm)
    kw = {"plain": dict(optional_silence=""),
          "silence": dict(),
          "ends": dict(silence_in_between=False)}.get(kind, {})
    seqs = (["a", "_", "a"], ["_", "a"])
    if kind == "union":
        return (j_net.union_fst(*[j_net.transcript_hmmnet(jm, jt, s)
                                  for s in seqs]),
                t_net.union_fst(*[t_net.transcript_hmmnet(tm, tt, s)
                                  for s in seqs]), jm, tm)
    return (j_net.transcript_hmmnet(jm, jt, seqs[0], **kw),
            t_net.transcript_hmmnet(tm, tt, seqs[0], **kw), jm, tm)


KINDS = ["plain", "silence", "ends", "union", "wordgraph",
         "wordgraph_prune"]


@pytest.mark.parametrize("kind", KINDS)
def test_builders_write_identical_files(tmp_path, kind):
    """transcript_hmmnet, union_fst and wordgraph_hmmnet (with and
    without posterior pruning) build the same networks: the same arcs,
    instance ids and word names, and the same MIT-FST bytes."""
    jf, tf, _, _ = _networks(kind)
    assert [vars(a) for a in tf.arcs] == [vars(a) for a in jf.arcs]
    assert (tf.initial, tf.final, tf.num_nodes, tf.word_names) == (
        jf.initial, jf.final, jf.num_nodes, jf.word_names)
    j_fst.write_fst(jf, str(tmp_path / "j.fst"))
    t_fst.write_fst(tf, str(tmp_path / "t.fst"))
    assert (tmp_path / "t.fst").read_bytes() == (tmp_path / "j.fst").read_bytes()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("opts", [
    dict(), dict(acoustic_scale=0.5, use_static_scores=False),
    dict(use_transition_probs=False)])
def test_compile_and_pad_identical(kind, opts):
    """compile_hmmnet (positions, edges, entry/final, constants,
    instances, mpv groups), pad_hmmnet (its `inst` padded with 0, as the
    reference pads it) and shift_compile give identical tables; a
    network read back from its file compiles the same way (instances
    from the label components)."""
    jf, tf, jm, tm = _networks(kind)
    jt, tt = _tables(jm, tm)
    jg, jemit = j_net.compile_hmmnet(jf, jt, **opts)
    tg, temit = t_net.compile_hmmnet(tf, tt, **opts)
    assert temit == jemit
    _same_graph(tg, jg)
    _same_graph(convert.hmmnet_graph(jg), jg)
    P = int(jg["num_positions"])
    for pad, fan in ((P, 0), (P + 5, 7)):
        jp = j_net.pad_hmmnet(jg, pad, fan=fan)
        tp = t_net.pad_hmmnet(tg, pad, fan=fan)
        _same_graph(tp, jp)
        _same_graph(t_estep.shift_compile(tp), j_estep.shift_compile(jp))
    text = _fst_text(j_fst, jf)
    jr, _ = j_net.compile_hmmnet(j_fst.parse_fst(text), jt, **opts)
    tr, _ = t_net.compile_hmmnet(t_fst.parse_fst(text), tt, **opts)
    _same_graph(tr, jr)


def test_pad_hmmnet_refuses_overflow():
    jf, tf, jm, tm = _networks("silence")
    tg, _ = t_net.compile_hmmnet(tf, _tables(jm, tm)[1])
    with pytest.raises(ValueError, match="exceeds padding"):
        t_net.pad_hmmnet(tg, int(tg["num_positions"]) - 1)


# -- forward-backward on hmmnet graphs ------------------------------------------------

def _net_graph(seed, labels=("a", "a", "_"), pad=3, fan=4, shift=False,
               **kw):
    jm = three_state_model(seed=seed)
    table = j_hmm.TransitionTable.from_model(jm)
    fst = j_net.transcript_hmmnet(jm, table, list(labels), **kw)
    g, _ = j_net.compile_hmmnet(fst, table)
    g = j_net.pad_hmmnet(g, int(g["num_positions"]) + pad, fan=fan)
    return (j_estep.shift_compile(g) if shift else g), table


def _union_graph(seed, pad=2):
    jm = three_state_model(seed=seed)
    table = j_hmm.TransitionTable.from_model(jm)
    fst = j_net.union_fst(
        j_net.transcript_hmmnet(jm, table, ["a", "_"]),
        j_net.transcript_hmmnet(jm, table, ["_", "a", "a"]))
    g, _ = j_net.compile_hmmnet(fst, table)
    return j_net.pad_hmmnet(g, int(g["num_positions"]) + pad, fan=6), table


@pytest.mark.parametrize("kind", ["transcript", "union"])
def test_mpv_matches_reference(kind):
    """masked_multipath_viterbi_fb on a batch of three (different
    lengths): gamma atol 2e-4, totals rel 1e-5, the liveness of the
    realized arcs identical, trans_post identical (only final slots)."""
    g, table = (_net_graph(1, silence_in_between=False)
                if kind == "transcript" else _union_graph(13))
    obs = np.stack([_obs(g, 12, s) for s in (2, 3, 4)])
    ns = (12, 7, 10)
    tga, tta, tla, tlive = t_estep.masked_multipath_viterbi_fb(
        torch.as_tensor(obs), _tg(g, g, g), _n(*ns), table.num_slots,
        with_live=True)
    ga, ta, la, live = _jbatch(j_estep.masked_multipath_viterbi_fb, obs,
                               [g] * 3, ns, table.num_slots, with_live=True)
    np.testing.assert_allclose(_np(tla), np.asarray(la), rtol=1e-5)
    np.testing.assert_allclose(_np(tga), np.asarray(ga), atol=2e-4)
    np.testing.assert_array_equal(_np(tta), np.asarray(ta))
    np.testing.assert_array_equal(_np(tlive), np.asarray(live))
    assert not _np(tga)[1, 7:].any()


def test_mpv_float64_mirror_and_bounds():
    """`tests/test_mpv.py`: the float64 mirror of the reference
    recursion (atol 2e-3, total rel 1e-4); singleton groups give plain
    Baum-Welch; the total lies between the Viterbi score and the BW
    total."""
    g, table = _net_graph(1, silence_in_between=False)
    T = 12
    obs = _obs(g, T, seed=2)
    gamma, _, total = t_estep.masked_multipath_viterbi_fb(
        torch.as_tensor(obs)[None], _tg(g), _n(T), table.num_slots)
    gamma_np, total_np = np_mpv_fb(obs.astype(np.float64), g)
    assert float(total) == pytest.approx(total_np, rel=1e-4)
    np.testing.assert_allclose(_np(gamma[0]), gamma_np, atol=2e-3)
    single = dict(g, mpv_gid=np.arange(g["pdf"].shape[0], dtype=np.int32))
    gm, _, tm_ = t_estep.masked_multipath_viterbi_fb(
        torch.as_tensor(obs)[None], _tg(single), _n(T), table.num_slots)
    gb, _, tb = t_estep.masked_forward_backward(
        torch.as_tensor(obs)[None], _tg(g), _n(T), table.num_slots)
    assert float(tm_) == pytest.approx(float(tb), rel=1e-5)
    np.testing.assert_allclose(_np(gm), _np(gb), atol=1e-4)
    _, tv = t_estep.masked_viterbi(torch.as_tensor(obs)[None], _tg(g), _n(T))
    assert float(tv) <= float(total) + 1e-4 <= float(tb) + 2e-4


def _np_realize(val, gid):
    """Group maximum, ties to the lowest position, live values only."""
    real = np.zeros(val.shape, bool)
    for b in range(val.shape[0]):
        for grp in np.unique(gid[b]):
            members = np.flatnonzero(gid[b] == grp)
            i = members[np.argmax(val[b, members])]   # first maximum
            real[b, i] = val[b, i] > -1e30 / 2
    return real


def test_realize_ties_to_the_lowest_position():
    """The realized set on planted ties within groups (and dead
    groups), against a mirror of the rule; and the whole recursion on a
    network whose every candidate ties, against the reference."""
    rng = np.random.default_rng(0)
    gid = rng.integers(0, 5, (3, 16))
    val = rng.choice([-1.0, -2.0, -1e30], size=(3, 16)).astype(np.float32)
    got = t_estep._realize(torch.as_tensor(val),
                           torch.as_tensor(gid, dtype=torch.int64))
    np.testing.assert_array_equal(_np(got), _np_realize(val, gid))
    g, table = _union_graph(22)
    g = dict(g, in_logp=np.where(g["in_logp"] > -1e29, -1.0,
                                 g["in_logp"]).astype(np.float32),
             out_logp=np.where(g["out_logp"] > -1e29, -1.0,
                               g["out_logp"]).astype(np.float32))
    obs = np.zeros((1, 10, g["pdf"].shape[0]), np.float32)
    tga, _, tla, tlive = t_estep.masked_multipath_viterbi_fb(
        torch.as_tensor(obs), _tg(g), _n(10), table.num_slots,
        with_live=True)
    ga, _, la, live = _jbatch(j_estep.masked_multipath_viterbi_fb, obs, [g],
                              (10,), table.num_slots, with_live=True)
    np.testing.assert_array_equal(_np(tlive), np.asarray(live))
    np.testing.assert_allclose(_np(tga), np.asarray(ga), atol=2e-4)
    assert float(tla[0]) == pytest.approx(float(la[0]), rel=1e-5)


def test_linear_hmmnet_matches_chain():
    """`tests/test_hmmnet.py`: a silence-free transcript network gives
    the chain's total, occupancies and transition statistics, through
    the port's E-step; a static entry score shifts the total by itself;
    optional silence raises the likelihood."""
    jm, tm = _models(seed=0)
    tt = t_hmm.TransitionTable.from_model(tm)
    ts = convert.gmm_scorer(JScorer.from_model(jm))
    labels = ["a", "_", "a"]
    X = torch.as_tensor(np.random.default_rng(0).normal(
        0, 2, (1, 14, jm.dim)).astype(np.float32))
    chain = t_hmm.build_chain(tm, tt, labels)
    cs = t_estep.chain_stats(ts, X, _tg(t_hmm.pad_chain(
        chain, chain.num_positions)), _n(14), tt.num_slots)

    def net_stats(fst, x=X):
        g, _ = t_net.compile_hmmnet(fst, tt)
        return t_estep.chain_stats(ts, x, _tg(t_net.pad_hmmnet(
            g, int(g["num_positions"]))), _n(x.shape[1]), tt.num_slots)

    hs = net_stats(t_net.transcript_hmmnet(tm, tt, labels,
                                           optional_silence=""))
    assert float(hs["log_likelihood"]) == pytest.approx(
        float(cs["log_likelihood"]), rel=1e-5)
    for k in ("gamma", "mean_acc", "trans_acc"):
        np.testing.assert_allclose(_np(hs[k]), _np(cs[k]), rtol=1e-3,
                                   atol=1e-3)
    one = t_net.transcript_hmmnet(tm, tt, ["a"], optional_silence="")
    shifted = t_net.transcript_hmmnet(tm, tt, ["a"], optional_silence="")
    for a in shifted.arcs:
        a.source += 1
        a.target += 1
    shifted.num_nodes += 1
    shifted.final += 1
    shifted.add_arc(t_fst.FstArc(0, shifted.initial + 1, score=-2.5))
    shifted.initial = 0
    x8 = X[:, :8]
    assert float(net_stats(shifted, x8)["log_likelihood"]) == pytest.approx(
        float(net_stats(one, x8)["log_likelihood"]) - 2.5, rel=1e-5)
    sil = net_stats(t_net.transcript_hmmnet(tm, tt, ["a"]), x8)
    assert float(sil["log_likelihood"]) >= float(
        net_stats(one, x8)["log_likelihood"]) - 1e-5
    assert float(sil["gamma"].sum()) == pytest.approx(8, rel=1e-4)


# -- chain_stats: mpv and the per-arc feature counts ------------------------------------

@pytest.mark.parametrize("mode,arc,shift", [
    ("mpv", False, False), ("mpv", True, True), ("bw", True, False),
    ("bw", True, True), ("vit", True, True)])
def test_chain_stats_hmmnet_modes_match_reference(mode, arc, shift):
    """chain_stats in `mpv` and with ``arc_feacount`` on two utterances
    of different lengths in one batch: feature counts identical, the
    rest at `_stats_close`'s tolerances."""
    g, table = _union_graph(31)
    if shift:
        g = j_estep.shift_compile(g)
    jm = three_state_model(seed=31)
    js = JScorer.from_model(jm)
    X = np.random.default_rng(2).normal(0, 2, (2, 12, jm.dim)).astype(
        np.float32)
    ns = (12, 9)
    got = t_estep.chain_stats(convert.gmm_scorer(js), torch.as_tensor(X),
                              _tg(g, g), _n(*ns), table.num_slots, mode=mode,
                              arc_feacount=arc)
    for b, n in enumerate(ns):
        want = j_estep.chain_stats(js, jnp.asarray(X[b]), _jg(g),
                                   jnp.int32(n), table.num_slots, mode=mode,
                                   arc_feacount=arc)
        _stats_close({k: _np(v[b]) for k, v in got.items()}, want,
                     f"{mode} utt {b}")
        assert np.asarray(want["feacount"]).sum() > 0


def test_arc_copies_chunked_over_frames(monkeypatch):
    """The per-arc counts do not depend on the frame chunking."""
    g, table = _union_graph(5)
    obs = np.stack([_obs(g, 11, s) for s in (1, 2)])
    _, _, _, live = t_estep.masked_forward_backward(
        torch.as_tensor(obs), _tg(g, g), _n(11, 6), table.num_slots,
        with_live=True)
    whole = t_estep._arc_copies(live, _tg(g, g), _n(11, 6))
    monkeypatch.setattr(t_estep, "_CHUNK_ELEMS", 1)
    np.testing.assert_array_equal(
        _np(t_estep._arc_copies(live, _tg(g, g), _n(11, 6))), _np(whole))
    assert int(whole.sum()) > 0


# -- state segmentation ----------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_state_segmentation_identical(tmp_path, seed):
    """`tests/test_stateseg.py`'s decodes through both Toolboxes: the
    same words, hypothesis networks, segments and .stateseg bytes."""
    model, lex, _ = make_task(tmp_path, seed=seed)
    rng = np.random.default_rng(seed + 100)
    words = [list(lex)[i] for i in rng.integers(0, len(lex), 3)]
    lna = synth_lna(tmp_path, model, lex, words, seed + 7, noise=0.8)
    lp, _ = read_lna(lna)
    out = []
    for cls, extra in ((JToolbox, {}), (TToolbox, {"device": "cpu"})):
        t = cls(str(tmp_path / "m.ph"), **extra)
        t.set_lm_scale(10.0)
        t.set_global_beam(400.0)
        t.set_duration_scale(0.0)
        t.set_require_sentence_end(True)
        t.set_silence_is_word(False)
        t.set_optional_short_silence(True)
        t.set_keep_state_segmentation(True)
        t.lex_read(str(tmp_path / "lex.dict"))
        t.set_sentence_boundary("<s>", "</s>")
        t.ngram_read(str(tmp_path / "lm.arpa"))
        res = t.lna_decode(lna)
        segs = [(s.start, s.end, s.state)
                for s in t.state_segmentation(res, lp)]
        path = tmp_path / f"{cls.__module__.split('.')[0]}.stateseg"
        t.write_state_segmentation(str(path), res, lp)
        out.append((list(res.words), segs, path.read_bytes()))
    assert out[1] == out[0]
    assert out[0][1] and out[0][1][-1][1] == lp.shape[0]


def test_hypothesis_fst_and_segments_identical(tmp_path):
    """hypothesis_fst with alternative pronunciations, context phones
    and silence lexicon entries writes the reference's file;
    state_segmentation on the same observations gives its segments
    (also from a tensor), and the writer its bytes."""
    jm, _, _ = make_decode_task()
    tm = convert.hmm_model(jm)
    jt, tt = _tables(jm, tm)
    prons = [[["a", "b"], ["b", "a"]], [["c", "a"]], [["a"]]]
    sil = [["_"]]
    jf = j_hyp_fst(jm, jt, prons, silence_prons=sil)
    tf = t_hyp_fst(tm, tt, prons, silence_prons=sil)
    assert _fst_text(t_fst, tf) == _fst_text(j_fst, jf)
    assert [a.inst for a in tf.arcs] == [a.inst for a in jf.arcs]
    rng = np.random.default_rng(3)
    obs = rng.normal(-4, 2, (30, jm.num_states)).astype(np.float32)
    want = j_stateseg(jm, jt, obs, 27, prons, silence_prons=sil)
    for o in (obs, torch.as_tensor(obs)):
        got = t_stateseg(tm, tt, o, 27, prons, silence_prons=sil)
        assert [vars(s) for s in got] == [vars(s) for s in want]
    write_state_segmentation(str(tmp_path / "t"), got)
    from aaltoasr_tpu.decoder.stateseg import (
        write_state_segmentation as j_write)
    j_write(str(tmp_path / "j"), want)
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
