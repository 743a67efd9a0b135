"""PyTorch port, lattices: the record scores of both engines, word graphs
and their SLF text, n-best lists, posteriors and confusion networks, the
SLF tools, lattice grammars, `InterTreeGram` and TreeGram binaries,
against the JAX package on the same inputs (CPU).

Tolerances:
- records: words and pointers identical; am and lm scores within rtol
  1e-5, atol 1e-3 (the exact engine's tests: float32 sums in another
  order); with ``records_half`` within one bfloat16 step of the
  reference's record (two float32 values a few ulps apart can round to
  neighbouring bfloat16 values);
- SLF text, parsed: node frames, arc keys (S, E, W) and their order
  identical; arc a and l within atol 2e-3 (differences of cumulative
  float32 scores, printed with %e);
- n-best: identical word sequences, scores within rtol 1e-5, atol 2e-3;
- arc posteriors and confusion-network confidences: within 1e-3;
- host code on the same input (SLF reading, writing and rescoring,
  best paths, oracle errors, lattice grammars, TreeGram binaries,
  InterTreeGram): identical results.
"""

import inspect
import io
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from aaltoasr_tpu.decoder import slf as jslf
from aaltoasr_tpu.decoder import wordgraph as jwg
from aaltoasr_tpu.decoder.intergram import InterTreeGram as JInterTreeGram
from aaltoasr_tpu.decoder.search import BeamSearch as JBeamSearch
from aaltoasr_tpu.decoder.search import SearchConfig as JConfig
from aaltoasr_tpu.decoder.search_dense import DenseBeamSearch as JDense
from aaltoasr_tpu.decoder.toolbox import Toolbox as JToolbox
from aaltoasr_tpu.formats import model_io as jmodel_io
from aaltoasr_tpu.formats import treegram_bin as jbin
from aaltoasr_tpu.formats.arpa import read_arpa as j_read_arpa

from aaltoasr_tpu_torch import convert, synth
from aaltoasr_tpu_torch.decoder import slf as tslf
from aaltoasr_tpu_torch.decoder import wordgraph as twg
from aaltoasr_tpu_torch.decoder.intergram import InterTreeGram
from aaltoasr_tpu_torch.decoder.search import BeamSearch
from aaltoasr_tpu_torch.decoder.search_dense import DenseBeamSearch
from aaltoasr_tpu_torch.decoder.toolbox import Toolbox
from aaltoasr_tpu_torch.formats import treegram_bin as tbin
from aaltoasr_tpu_torch.formats.arpa import read_arpa

from tests.test_decoder import ARPA_TEXT, make_decode_task, synth_obs
from tests.test_torch_exact import padded
from tests import test_slf
from tests.test_trigram_decode import TRIGRAM_ARPA, trigram_task

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmarks"))
import bench_decode  # noqa: E402

# the tests run tiny tensors in several worker processes at once: one
# intra-op thread each avoids oversubscribing the cores
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-3          # record scores
SLF_ATOL = 2e-3                  # parsed SLF arc scores
POST_ATOL = 1e-3                 # posteriors and confidences


def _mono():
    model, tree, fsa = make_decode_task()
    cfg = dict(num_tokens=24, num_records=8, beam=1e9, lm_scale=2.0)
    obs = [np.array(synth_obs(tree, model, seq, frames_per_phone=2,
                              noise=1.5, seed=seed))
           for seed, seq in [(0, ["a", "b", "b", "a"]),
                             (1, ["c", "a", "a", "b"]),
                             (2, ["_", "b", "a", "_"])]]
    return (model, tree, fsa), None, cfg, padded(obs)


def _trigram():
    model, tree, fsa, _ = trigram_task()
    cfg = dict(num_tokens=64, num_records=16, beam=1e9, lm_scale=8.0,
               duration_scale=0.0)
    obs = [np.array(synth_obs(tree, model, seq, noise=0.5, seed=seed))
           for seed, seq in [(0, ["a", "b", "b", "a", "_"]),
                             (1, ["a", "b", "c", "a"])]]
    return (model, tree, fsa), None, cfg, padded(obs)


def _crossword():
    """The 30-word cross-word triphone task with gamma durations and a
    trigram LM, built by both sides from the same seed; planted
    observations of two utterances of different lengths."""
    model, tree, fsa = bench_decode.synth_task(
        num_words=30, order=3, triphone=True, durations=True)
    info = bench_decode.synth_task.last_info
    T = 240
    obs_fn, _ = bench_decode.synth_obs(model, info, 2, T)
    obs = np.array(jax.jit(obs_fn)(jax.random.PRNGKey(1)))
    task = synth.synth_task(num_words=30, order=3, triphone=True,
                            durations=True)
    cfg = dict(num_tokens=64, num_records=16, lm_scale=30.0,
               duration_scale=3.0)
    return ((model, tree, fsa), (task.model, task.tree, task.fsa), cfg,
            (obs, np.array([T, T - 50])))


TASKS = {"mono": _mono, "trigram": _trigram, "crossword": _crossword}
_built: dict = {}


def task(name):
    if name not in _built:
        _built[name] = TASKS[name]()
    return _built[name]


def searches(engine, name, **knobs):
    """(reference search, port search) on one task and config."""
    ref_task, port_task, cfg, _ = task(name)
    jcfg = JConfig(**{**cfg, **knobs})
    model, tree, fsa = ref_task
    if port_task is None:
        port_task = (convert.hmm_model(model), convert.prefix_tree(tree),
                     convert.ngram_fsa(fsa))
    tmodel, ttree, tfsa = port_task
    jcls, tcls = ((JBeamSearch, BeamSearch) if engine == "exact"
                  else (JDense, DenseBeamSearch))
    return (jcls(tree, fsa, model, jcfg),
            tcls(ttree, tfsa, tmodel, convert.search_config(jcfg),
                 device="cpu"))


def bf16_step(x):
    """The spacing of bfloat16 values (8 significant bits) at |x|."""
    a = np.abs(np.asarray(x, np.float64))
    e = np.floor(np.log2(np.where(a > 0, a, 1.0)))
    return np.where(a > 0, 2.0 ** (e - 7), 0.0)


def assert_records(ref, got, half=False):
    assert got.words == ref.words
    assert (got.final_ptr, got.final_word) == (ref.final_ptr, ref.final_word)
    for f in ("log_prob", "final_am", "final_lms"):
        assert getattr(got, f) == pytest.approx(getattr(ref, f), rel=RTOL,
                                                abs=ATOL), f
    np.testing.assert_array_equal(got.rec_words, ref.rec_words)
    np.testing.assert_array_equal(got.rec_prevs, ref.rec_prevs)
    for f in ("rec_ams", "rec_lmss"):
        want, have = getattr(ref, f), getattr(got, f)
        assert have.dtype == np.float32
        if half:
            assert (np.abs(have.astype(np.float64) - want)
                    <= bf16_step(want)).all(), f
        else:
            np.testing.assert_allclose(have, want, rtol=RTOL, atol=ATOL)


def slf_text(graph) -> str:
    buf = io.StringIO()
    graph.write_slf(buf)
    return buf.getvalue()


def assert_same_slf(want_text, got_text):
    want, got = (tslf.SlfLattice.read(t) for t in (want_text, got_text))
    assert got.nodes == want.nodes
    assert (got.start, got.end, got.lm_scale, got.wdpenalty) == (
        want.start, want.end, want.lm_scale, want.wdpenalty)
    assert ([(a["S"], a["E"], a["W"]) for a in got.arcs]
            == [(a["S"], a["E"], a["W"]) for a in want.arcs])
    for k in ("a", "l"):
        np.testing.assert_allclose([a[k] for a in got.arcs],
                                   [a[k] for a in want.arcs],
                                   rtol=0, atol=SLF_ATOL)


def assert_same_nbest(want, got):
    assert [w for w, _ in got] == [w for w, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=RTOL, atol=SLF_ATOL)


def assert_same_confusion(want, got):
    assert [w for w, _, _ in got] == [w for w, _, _ in want]
    np.testing.assert_allclose([c for _, c, _ in got],
                               [c for _, c, _ in want], atol=POST_ATOL)
    for (_, _, wd), (_, _, gd) in zip(want, got):
        assert sorted(gd) == sorted(wd)
        np.testing.assert_allclose([gd[k] for k in sorted(gd)],
                                   [wd[k] for k in sorted(wd)],
                                   atol=POST_ATOL)


# -- dense records ---------------------------------------------------------

@pytest.mark.parametrize("half", [False, True])
@pytest.mark.parametrize("name,require_end", [
    ("mono", True), ("mono", False), ("trigram", True), ("crossword", True),
    ("crossword", False)])
def test_dense_records(name, require_end, half):
    """`decode_batch(lattice=True)`: the record words, pointers and
    scores of the dense engine, with and without bfloat16 records."""
    ref, port = searches("dense", name, require_sentence_end=require_end,
                         records_half=half)
    obs, n = task(name)[3]
    want = ref.decode_batch(obs, n, lattice=True)
    got = port.decode_batch(obs, n, lattice=True)
    assert any(r.words for r in want)
    for r, g in zip(want, got):
        assert_records(r, g, half)


@pytest.mark.parametrize("method", ["decode", "decode_batch"])
def test_dense_lattice_default(method):
    """`decode`/`decode_batch` default to lattice=True, as the
    reference's do, and so carry the records."""
    want = inspect.signature(getattr(JDense, method)).parameters["lattice"]
    got = inspect.signature(getattr(DenseBeamSearch, method)
                            ).parameters["lattice"]
    assert got.default is want.default is True
    ref, port = searches("dense", "mono")
    obs, n = task("mono")[3]
    if method == "decode":
        pairs = [(ref.decode(obs[0]), port.decode(obs[0]))]
    else:
        pairs = zip(ref.decode_batch(obs, n), port.decode_batch(obs, n))
    for r, g in pairs:
        assert g.rec_ams is not None
        assert_records(r, g)


# -- word graphs -----------------------------------------------------------

@pytest.mark.parametrize("name", list(TASKS))
@pytest.mark.parametrize("engine", ["exact", "dense"])
def test_word_graphs(engine, name):
    """Each utterance's word graph: its SLF text, n-best list, arc
    posteriors and confusion network."""
    ref, port = searches(engine, name, require_sentence_end=True)
    obs, n = task(name)[3]
    arcs = 0
    for r, g in zip(ref.decode_batch(obs, n), port.decode_batch(obs, n)):
        assert_records(r, g)
        rg, gg = r.word_graph(), g.word_graph()
        assert isinstance(gg, twg.WordGraph)
        assert_same_slf(slf_text(rg), slf_text(gg))
        arcs += len(gg.arcs)
        assert_same_nbest(rg.nbest(5), gg.nbest(5))
        np.testing.assert_allclose(twg.arc_posteriors(gg),
                                   jwg.arc_posteriors(rg), atol=POST_ATOL)
        assert_same_confusion(jwg.confusion_network(rg),
                              twg.confusion_network(gg))
    assert arcs > len(n)


def test_word_graph_needs_the_records():
    _, port = searches("dense", "mono")
    res = port.decode(task("mono")[3][0][0], lattice=False)
    assert res.rec_words is None and res.words
    with pytest.raises(RuntimeError, match="lattice=False"):
        res.word_graph()


# -- SLF host code ---------------------------------------------------------

@pytest.fixture(scope="module")
def decoded_slf():
    """The SLF text of a decoded lattice on the monophone task."""
    ref, _ = searches("exact", "trigram", require_sentence_end=True)
    obs, n = task("trigram")[3]
    return slf_text(ref.decode(obs[0][:n[0]]).word_graph())


BOOSTED = ARPA_TEXT.replace("-0.2 yksi kaksi", "-9.0 yksi kaksi").replace(
    "-0.4 kolme yksi", "-0.4 kolme yksi\n-0.01 yksi kolme").replace(
    "ngram 2=6", "ngram 2=7")


def _write(lat):
    buf = io.StringIO()
    lat.write(buf)
    return buf.getvalue()


@pytest.mark.parametrize("source", ["decoded", "diamond", "grammar"])
def test_slf_host_ops(decoded_slf, source):
    """read/write, rescore (ARPA, boosted ARPA, interpolated),
    best_path, nbest and oracle_error on the same text."""
    text = {"decoded": decoded_slf, "diamond": test_slf.DIAMOND,
            "grammar": test_slf.TestLatticeGrammar.SLF}[source]
    want, got = jslf.SlfLattice.read(text), tslf.SlfLattice.read(text)
    assert _write(got) == _write(want)
    assert got.best_path() == want.best_path()
    assert got.nbest(5) == want.nbest(5)
    words = want.best_path()[0]
    for ref_words in (words, words[:-1], ["yksi", "kolme", "x"], []):
        assert got.oracle_error(ref_words) == want.oracle_error(ref_words)
    for arpa in (ARPA_TEXT, BOOSTED, TRIGRAM_ARPA):
        jlm, tlm = j_read_arpa(arpa), read_arpa(arpa)
        out_w, out_g = want.rescore(jlm), got.rescore(tlm)
        assert _write(out_g) == _write(out_w)
        assert out_g.best_path() == out_w.best_path()
        assert out_g.nbest(3) == out_w.nbest(3)
    mixed_w = JInterTreeGram([j_read_arpa(ARPA_TEXT), j_read_arpa(BOOSTED)],
                             [0.6, 0.4])
    mixed_g = InterTreeGram([read_arpa(ARPA_TEXT), read_arpa(BOOSTED)],
                            [0.6, 0.4])
    assert _write(got.rescore(mixed_g)) == _write(want.rescore(mixed_w))


def test_intertreegram_log_probs():
    lms = [ARPA_TEXT, BOOSTED, TRIGRAM_ARPA]
    want = JInterTreeGram([j_read_arpa(t) for t in lms], [0.5, 0.3, 0.2])
    got = InterTreeGram([read_arpa(t) for t in lms], [0.5, 0.3, 0.2])
    assert (got.order, got.vocab, got.word_index) == (
        want.order, want.vocab, want.word_index)
    V = len(want.vocab)
    for ctx in [()] + [(a,) for a in range(V)] + [(a, b) for a in range(V)
                                                  for b in range(V)]:
        for w in range(V):
            assert got.log_prob(ctx, w) == want.log_prob(ctx, w)
    with pytest.raises(ValueError):
        InterTreeGram([read_arpa(ARPA_TEXT)] * 2, [0.5, 0.1])


# -- lattice grammars ------------------------------------------------------

# admits only "kaksi kolme" and "kaksi yksi" (test_slf's constrained
# decode)
CONSTRAINED = """\
VERSION=1.0
N=3 L=3
I=0 t=0.0
I=1 t=0.1
I=2 t=0.2
J=0 S=0 E=1 W=kaksi a=0 l=0
J=1 S=1 E=2 W=kolme a=0 l=0
J=2 S=1 E=2 W=yksi a=0 l=0
"""


@pytest.mark.parametrize("source", ["grammar", "constrained", "decoded"])
@pytest.mark.parametrize("engine", ["exact", "dense"])
def test_lattice_grammar_decodes(decoded_slf, engine, source):
    """The grammar FSA (order 1, contexts None, no backoff) equals the
    reference's and decodes through both engines to the same words and
    records; a grammar that admits only other words moves the result
    off the acoustics' preference ("yksi kaksi")."""
    text = {"grammar": test_slf.TestLatticeGrammar.SLF,
            "constrained": CONSTRAINED, "decoded": decoded_slf}[source]
    want = jslf.lattice_grammar(jslf.SlfLattice.read(text))
    got = tslf.lattice_grammar(tslf.SlfLattice.read(text))
    assert (got.order, got.vocab, got.context_of_state) == (
        1, want.vocab, want.context_of_state)
    for f in ("trans_word", "trans_prob", "trans_next", "state_first",
              "bo_weight", "bo_next"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    model, tree, _ = make_decode_task()
    obs = np.array(synth_obs(tree, model, ["_", "a", "b", "b", "a", "_"]))
    cfg = JConfig(num_tokens=64, num_records=8, beam=1e9, lm_scale=1.0,
                  duration_scale=0.0)
    jcls, tcls = ((JBeamSearch, BeamSearch) if engine == "exact"
                  else (JDense, DenseBeamSearch))
    r = jcls(tree, want, model, cfg).decode(obs)
    g = tcls(convert.prefix_tree(tree), got, convert.hmm_model(model),
             convert.search_config(cfg), device="cpu").decode(obs)
    assert_records(r, g)
    assert r.words
    if source == "constrained":
        assert g.words[0] == "kaksi" and g.words != ["yksi", "kaksi"]


def _toolboxes(tmp_path):
    model, _, _ = make_decode_task()
    jmodel_io.write_model(str(tmp_path / "m"), model)
    (tmp_path / "lex").write_text("yksi a b\nkaksi b a\nkolme c a\n_ _\n")
    out = []
    for t in (JToolbox(str(tmp_path / "m.ph")),
              Toolbox(str(tmp_path / "m.ph"), device="cpu")):
        t.set_lm_scale(1.0)
        t.set_duration_scale(0.0)
        t.set_global_beam(1e9)
        t.lex_read(str(tmp_path / "lex"))
        out.append(t)
    obs = np.array(synth_obs(make_decode_task()[1], model,
                             ["_", "a", "b", "b", "a", "_"]))
    return out, obs


def test_toolbox_lattice_calls(tmp_path):
    """`htk_lattice_grammar_read`, `set_generate_word_graph` with
    `lna_decode`, and `ngram_read(binary=True)` through both
    Toolboxes on the same files."""
    from aaltoasr_tpu.formats.lna import write_lna
    (jt, tt), obs = _toolboxes(tmp_path)
    lna = str(tmp_path / "u.lna")
    write_lna(lna, obs - np.log(np.exp(obs).sum(1, keepdims=True)), 2)
    (tmp_path / "g.slf").write_text(test_slf.TestLatticeGrammar.SLF)
    for t in (jt, tt):
        t.htk_lattice_grammar_read(str(tmp_path / "g.slf"))
    assert_records(jt.lna_decode(lna), tt.lna_decode(lna))
    tt.set_generate_word_graph(True)
    jt.set_generate_word_graph(True)
    r, g = jt.lna_decode(lna, lattice=False), tt.lna_decode(lna, lattice=False)
    assert g.rec_words is not None
    assert_records(r, g)
    tt.set_generate_word_graph(False)
    assert tt.lna_decode(lna, lattice=False).rec_words is None
    jbin.write_bin(j_read_arpa(ARPA_TEXT), str(tmp_path / "lm.bin"))
    (tmp_path / "lm.arpa").write_text(ARPA_TEXT)
    tt.ngram_read(str(tmp_path / "lm.bin"), binary=True)
    jt.ngram_read(str(tmp_path / "lm.bin"), binary=True)
    from_bin = tt.lna_decode(lna)
    assert_records(jt.lna_decode(lna), from_bin)
    tt.ngram_read(str(tmp_path / "lm.arpa"))
    assert_records(from_bin, tt.lna_decode(lna))


# -- TreeGram binaries -----------------------------------------------------

@pytest.mark.parametrize("kind", ["backoff", "interpolated"])
@pytest.mark.parametrize("arpa", ["bigram", "trigram"])
def test_treegram_bin_round_trip(tmp_path, arpa, kind):
    """The port writes the reference's bytes, reads the reference's
    file to the same model, and its own file back to the ARPA's."""
    text = {"bigram": ARPA_TEXT, "trigram": TRIGRAM_ARPA}[arpa]
    jbin.write_bin(j_read_arpa(text), str(tmp_path / "j.bin"), kind)
    tbin.write_bin(read_arpa(text), str(tmp_path / "t.bin"), kind)
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin"
                                                 ).read_bytes()
    want = jbin.read_bin(str(tmp_path / "j.bin"))
    got = tbin.read_bin(str(tmp_path / "j.bin"))
    assert (got.order, got.vocab, got.ngrams) == (want.order, want.vocab,
                                                  want.ngrams)
    back = tbin.read_bin(str(tmp_path / "t.bin"))
    src = read_arpa(text)
    assert back.vocab == src.vocab
    for o in range(1, src.order + 1):
        assert sorted(back.ngrams[o]) == sorted(src.ngrams[o])
        for k, (lp, bo) in src.ngrams[o].items():
            assert back.ngrams[o][k] == pytest.approx((lp, bo), abs=1e-6)
