"""PyTorch port, exact engine: `BeamSearch`, `Toolbox` and the
recombination sort against the JAX package on the same inputs (CPU).

Words, the word committed at the final frame, the record words and the
record pointers must be identical.  Scores (the final total, am and lm
parts, the records' am and lm parts) agree within rtol 1e-5 and atol
1e-3: float32 sums over up to ~1000 frames, and XLA's log against
torch's in the duration bonus.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aaltoasr_tpu.decoder.lexicon import build_prefix_tree, read_lexicon
from aaltoasr_tpu.decoder.ngram import NGramFsa
from aaltoasr_tpu.decoder import search as jsearch
from aaltoasr_tpu.decoder.search import BeamSearch as JBeamSearch
from aaltoasr_tpu.decoder.search import SearchConfig as JConfig
from aaltoasr_tpu.decoder.toolbox import Toolbox as JToolbox
from aaltoasr_tpu.formats.arpa import read_arpa

from aaltoasr_tpu_torch import convert, synth
from aaltoasr_tpu_torch.decoder import search as tsearch
from aaltoasr_tpu_torch.decoder.search import BeamSearch, recombine
from aaltoasr_tpu_torch.decoder.toolbox import Toolbox

from tests.test_decoder import ARPA_TEXT, make_decode_task, synth_obs
from tests.test_golden_decode import synth_lna
from tests.test_golden_morph import MORPHS
from tests.test_golden_morph import make_task as make_morph_task
from tests.test_golden_morph import synth as synth_morph_lna
from tests.test_multiwords import make_mw_task
from tests.test_trigram_decode import trigram_task

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmarks"))
import bench_decode  # noqa: E402

# the tests run tiny tensors in several worker processes at once: one
# intra-op thread each avoids oversubscribing the cores
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-3


def assert_same(ref, got):
    assert got.words == ref.words
    assert got.final_word == ref.final_word
    assert got.final_ptr == ref.final_ptr
    for f in ("log_prob", "final_am", "final_lms"):
        assert getattr(got, f) == pytest.approx(getattr(ref, f), rel=RTOL,
                                                abs=ATOL), f
    if ref.rec_words is None:
        assert got.rec_words is None and got.rec_ams is None
        return
    np.testing.assert_array_equal(got.rec_words, ref.rec_words)
    np.testing.assert_array_equal(got.rec_prevs, ref.rec_prevs)
    for f in ("rec_ams", "rec_lmss"):
        np.testing.assert_allclose(getattr(got, f), getattr(ref, f),
                                   rtol=RTOL, atol=ATOL)


def port_search(tree, fsa, model, cfg):
    return BeamSearch(convert.prefix_tree(tree), convert.ngram_fsa(fsa),
                      convert.hmm_model(model), convert.search_config(cfg),
                      device="cpu")


def padded(obs_list, fill=-100.0):
    T = max(o.shape[0] for o in obs_list)
    out = np.full((len(obs_list), T, obs_list[0].shape[1]), fill, np.float32)
    for i, o in enumerate(obs_list):
        out[i, :o.shape[0]] = o
    return out, np.array([o.shape[0] for o in obs_list])


# each knob alone, then all at the bench's operating point
# (bench.py:150-153, scaled to the task)
MONO_KNOBS = {
    "default": {},
    "overflow_tokens": {"overflow_tokens": 4},
    "we_prewalk": {"we_prewalk": 6},
    "word_end_beam": {"word_end_beam": 4.0},
    "reentry_records": {"reentry_records": 2},
    "reentry_prewalk": {"reentry_prewalk": 2},
    "lookahead_1": {"lm_lookahead": 1},
    "lookahead_2": {"lm_lookahead": 2},
    "bench_point": {"overflow_tokens": 4, "we_prewalk": 6,
                    "reentry_records": 2, "reentry_prewalk": 2},
}
MONO_CASES = [(0, ["a", "b", "b", "a"]), (1, ["c", "a", "a", "b"]),
              (2, ["_", "b", "a", "_"]), (3, ["a", "b", "c", "a", "_"])]


@pytest.mark.parametrize("require_end", [False, True])
@pytest.mark.parametrize("knob", list(MONO_KNOBS))
def test_monophone_bigram(knob, require_end):
    """The tiny monophone task with its bigram, noisy acoustics so
    several hypotheses stay close, four utterances in one batch."""
    model, tree, fsa = make_decode_task()
    cfg = JConfig(num_tokens=24, num_records=8, beam=1e9, lm_scale=2.0,
                  require_sentence_end=require_end, **MONO_KNOBS[knob])
    obs, n = padded([np.array(synth_obs(tree, model, seq, frames_per_phone=2,
                                        noise=1.5, seed=seed))
                     for seed, seq in MONO_CASES])
    ref = JBeamSearch(tree, fsa, model, cfg).decode_batch(obs, n)
    got = port_search(tree, fsa, model, cfg).decode_batch(obs, n)
    for r, g in zip(ref, got):
        assert_same(r, g)


HOMOPHONE_ARPA = ARPA_TEXT.replace("ngram 1=5", "ngram 1=6").replace(
    "ngram 2=6", "ngram 2=8").replace(
    "-0.9 kolme -0.2\n", "-0.9 kolme -0.2\n-0.7 kaxi -0.3\n").replace(
    "-0.5 kaksi </s>\n",
    "-0.5 kaksi </s>\n-0.1 yksi kaxi\n-0.1 kaxi </s>\n")


@pytest.mark.parametrize("knob", ["default", "we_prewalk", "bench_point"])
def test_homophones(knob):
    """Two words on one node (H=2 word-end slots): the word-end layout
    [W, H] through the prewalk, the records and the final commit."""
    model, _, _ = make_decode_task()
    tree = build_prefix_tree(model, read_lexicon(
        "yksi a b\nkaksi b a\nkaxi b a\nkolme c a\n_ _\n"))
    fsa = NGramFsa.from_arpa(read_arpa(HOMOPHONE_ARPA))
    assert tree.we_word.shape[1] == 2
    cfg = JConfig(num_tokens=24, num_records=8, beam=1e9, lm_scale=2.0,
                  require_sentence_end=True, **MONO_KNOBS[knob])
    obs, n = padded([np.array(synth_obs(tree, model, seq, frames_per_phone=2,
                                        noise=1.5, seed=seed))
                     for seed, seq in MONO_CASES])
    ref = JBeamSearch(tree, fsa, model, cfg).decode_batch(obs, n)
    got = port_search(tree, fsa, model, cfg).decode_batch(obs, n)
    assert any("kaxi" in r.words for r in ref)
    for r, g in zip(ref, got):
        assert_same(r, g)


@pytest.mark.parametrize("lattice", [True, False])
def test_trigram_decode_and_batch(lattice):
    """The trigram task: `decode` one utterance at a time against
    `decode_batch` of all of them, each against the reference."""
    model, tree, fsa, _ = trigram_task()
    cfg = JConfig(num_tokens=64, num_records=16, beam=1e9, lm_scale=8.0,
                  duration_scale=0.0, require_sentence_end=True)
    obs_list = [np.array(synth_obs(tree, model, seq, noise=0.5, seed=seed))
                for seed, seq in [(0, ["a", "b", "b", "a", "_"]),
                                  (1, ["a", "b", "c", "a"]),
                                  (2, ["b", "a", "c", "a", "_"])]]
    ref = JBeamSearch(tree, fsa, model, cfg)
    port = port_search(tree, fsa, model, cfg)
    obs, n = padded(obs_list)
    batch = port.decode_batch(obs, n, lattice=lattice)
    for o, b in zip(obs_list, batch):
        one = port.decode(o, lattice=lattice)
        assert_same(ref.decode(o, lattice=lattice), one)
        if lattice:
            # the batch's records run to its longest utterance; the
            # frames past this one's end hold no record
            F = len(one.rec_words)
            assert (b.rec_words[F:] == -1).all()
            assert (b.rec_prevs[F:] == -1).all()
            for f in ("rec_words", "rec_prevs", "rec_ams", "rec_lmss"):
                setattr(b, f, getattr(b, f)[:F])
        assert_same(one, b)


def test_lattice_flag_keeps_the_same_result():
    """lattice=False fetches only the 1-best's records: the same words
    (the final commit folded in) and scores as lattice=True."""
    model, tree, fsa, _ = trigram_task()
    cfg = JConfig(num_tokens=64, num_records=16, beam=1e9, lm_scale=8.0,
                  duration_scale=0.0, require_sentence_end=True)
    port = port_search(tree, fsa, model, cfg)
    obs = np.array(synth_obs(tree, model, ["a", "b", "c", "a"], noise=0.5,
                             seed=1))
    full, fast = port.decode(obs), port.decode(obs, lattice=False)
    assert fast.rec_words is None and full.rec_words is not None
    assert fast.words == full.words and fast.words
    assert (fast.log_prob, fast.final_am, fast.final_lms) == (
        full.log_prob, full.final_am, full.final_lms)


@pytest.fixture(scope="module")
def xw_task():
    """A 30-word cross-word triphone task with gamma durations and a
    trigram LM, built by both sides from the same seed, and planted
    observations of three utterances of different lengths."""
    model, tree, fsa = bench_decode.synth_task(
        num_words=30, order=3, triphone=True, durations=True)
    info = bench_decode.synth_task.last_info
    B, T = 3, 320
    obs_fn, _ = bench_decode.synth_obs(model, info, B, T)
    obs = np.array(jax.jit(obs_fn)(jax.random.PRNGKey(1)))
    task = synth.synth_task(num_words=30, order=3, triphone=True,
                            durations=True)
    return model, tree, fsa, task, obs, np.array([T, T - 40, T - 90])


XW_KNOBS = {
    "default": {},
    "tokens_below_row": {"num_tokens": 24},   # W < R: top-W seeding
    "overflow_tokens": {"overflow_tokens": 16},
    "we_prewalk": {"we_prewalk": 24},
    "word_end_beam": {"word_end_beam": 60.0},
    "reentry_records": {"reentry_records": 4},
    "reentry_prewalk": {"reentry_prewalk": 4},
    "lookahead_1": {"lm_lookahead": 1},
    "lookahead_2": {"lm_lookahead": 2},
    "bench_point": {"num_tokens": 512, "num_records": 32,
                    "overflow_tokens": 128, "we_prewalk": 256,
                    "reentry_records": 8, "reentry_prewalk": 8},
}


@pytest.mark.parametrize("knob", list(XW_KNOBS))
def test_crossword_trigram_durations(xw_task, knob):
    """Cross-word triphones, gamma durations (scale 3), trigram LM at
    lm_scale 30; the port builds its own task from the seed."""
    model, tree, fsa, task, obs, n = xw_task
    kw = {"num_tokens": 64, "num_records": 16, **XW_KNOBS[knob]}
    cfg = JConfig(lm_scale=30.0, duration_scale=3.0,
                  require_sentence_end=knob in ("default", "bench_point"),
                  **kw)
    ref = JBeamSearch(tree, fsa, model, cfg).decode_batch(obs, n)
    got = BeamSearch(task.tree, task.fsa, task.model,
                     convert.search_config(cfg),
                     device="cpu").decode_batch(obs, n)
    assert any(r.words for r in ref)
    for r, g in zip(ref, got):
        assert_same(r, g)


@pytest.mark.parametrize("table", ["tree_dfs_intervals",
                                   "unigram_lookahead", "bigram_lookahead"])
def test_lookahead_tables(xw_task, table):
    """The host lookahead tables of the cross-word task (multiword-free
    vocabulary: the first components are the words) equal the
    reference's."""
    model, tree, fsa, task, _, _ = xw_task
    args = (tree,) if table == "tree_dfs_intervals" else (
        tree, fsa, tree.vocab)
    targs = (task.tree,) if table == "tree_dfs_intervals" else (
        task.tree, task.fsa, task.tree.vocab)
    want = getattr(jsearch, table)(*args)
    got = getattr(tsearch, table)(*targs)
    if table == "tree_dfs_intervals":
        for w, g in zip(want, got):            # (lo, hi)
            np.testing.assert_array_equal(g, w)
        assert (got[1] > got[0]).sum() > tree.num_nodes // 2
    else:
        np.testing.assert_array_equal(got, want)


def configure(t, tmp_path, lm_name="lm.arpa", lex_name="lex.dict", **knobs):
    """The same setter calls on either package's Toolbox."""
    for name, value in knobs.items():
        getattr(t, f"set_{name}")(*value if isinstance(value, tuple)
                                  else (value,))
    t.lex_read(str(tmp_path / lex_name))
    t.ngram_read(str(tmp_path / lm_name))
    return t


def test_morph_lm(tmp_path):
    """Morph mode through both Toolboxes on the same files: `<w>`
    committed by the short silence, the double-boundary prune, the
    sentence-end restart of the LM."""
    model = make_morph_task(tmp_path, durations=True)
    knobs = dict(lm_scale=10.0, global_beam=250.0, token_limit=256,
                 duration_scale=3.0, require_sentence_end=True,
                 silence_is_word=True, optional_short_silence=True,
                 word_boundary="<w>")
    args = (str(tmp_path / "m.ph"), str(tmp_path / "m.dur"))
    ref = configure(JToolbox(*args), tmp_path, lex_name="our_lex.dict",
                    **knobs)
    got = configure(Toolbox(*args, device="cpu"), tmp_path,
                    lex_name="our_lex.dict", **knobs)
    names = sorted(MORPHS)
    rng = np.random.default_rng(9)
    boundaries = 0
    for i in range(4):
        seq = [names[int(rng.integers(len(names)))]
               for _ in range(int(rng.integers(2, 5)))]
        lna = synth_morph_lna(tmp_path, model, seq, with_ss=(i % 2 == 0),
                              seed=400 + i, name=f"m{i}.lna")
        r = ref.lna_decode(lna)
        assert_same(r, got.lna_decode(lna))
        boundaries += r.words.count("<w>")
    assert boundaries > 0


@pytest.mark.parametrize("split,in_lm,seq", [
    (True, False, ["ab_ca"]), (False, False, ["ab", "ca"]),
    (False, True, ["ab_ca"])])
def test_multiwords(tmp_path, split, in_lm, seq):
    """Multiwords scored as their components (split) or as LM units,
    through both Toolboxes on the same files."""
    model, lex = make_mw_task(tmp_path, with_mw_in_lm=in_lm)
    lna = synth_lna(tmp_path, model, lex, seq, seed=3, noise=0.2,
                    name="mw.lna")
    knobs = dict(lm_scale=10.0, global_beam=400.0, duration_scale=0.0,
                 insertion_penalty=-2.0, require_sentence_end=True,
                 silence_is_word=False, optional_short_silence=True,
                 split_multiwords=split)
    ref = configure(JToolbox(str(tmp_path / "m.ph")), tmp_path, **knobs)
    got = configure(Toolbox(str(tmp_path / "m.ph"), device="cpu"), tmp_path,
                    **knobs)
    r = ref.lna_decode(lna)
    assert ("ab_ca" in r.words) == (seq == ["ab_ca"])
    assert_same(r, got.lna_decode(lna))


def _lax_recombine(node, lm, total, alive, W):
    """The reference's recombination and top-W sorts
    (`aaltoasr_tpu/decoder/search.py:1643-1677`, the unfused keys) on
    one utterance's candidates."""
    INT_MAX = np.iinfo(np.int32).max
    node, lm, total, alive = (jnp.asarray(x) for x in (node, lm, total,
                                                       alive))
    sort_node = jnp.where(alive, node, INT_MAX)
    neg_total = jnp.where(alive, -total, jnp.inf)
    idx0 = jnp.arange(node.shape[0], dtype=jnp.int32)
    s_node, s_lm, s_negt, s_idx = jax.lax.sort(
        (sort_node, lm, neg_total, idx0), num_keys=3)
    diff = (s_node[1:] != s_node[:-1]) | (s_lm[1:] != s_lm[:-1])
    first = jnp.concatenate([jnp.asarray([True]), diff])
    s_alive = first & (s_node != INT_MAX)
    neg2 = jnp.where(s_alive, s_negt, jnp.inf)
    o2 = jax.lax.sort((neg2, s_idx), num_keys=1)
    return np.asarray(o2[1][:W]), np.asarray(-o2[0][:W] > -jnp.inf)


@pytest.mark.parametrize("seed", range(4))
def test_recombination_ties(seed):
    """Candidates sharing (node, LM state) with equal totals — 0.0
    beside -0.0, dead candidates, -inf totals — keep the candidate the
    reference's stable lexicographic sort keeps, and the top-W order of
    equal totals is the reference's."""
    rng = np.random.default_rng(seed)
    C, W, S = 96, 40, 5
    node = rng.integers(0, 6, C).astype(np.int32)
    lm = rng.integers(0, S, C).astype(np.int32)
    total = rng.choice(np.array([0.0, -0.0, -1.5, 2.25, -np.inf],
                                np.float32), C)
    alive = rng.random(C) < 0.8
    sel, ok = _lax_recombine(node, lm, total, alive, W)
    got_sel, got_ok = recombine(
        torch.tensor(node, dtype=torch.int64)[None],
        torch.tensor(lm, dtype=torch.int64)[None],
        torch.tensor(total)[None], torch.tensor(alive)[None], S, W)
    np.testing.assert_array_equal(got_ok[0].numpy(), ok)
    # the live tokens are the same candidates in the same order (dead
    # slots carry no state the search reads)
    np.testing.assert_array_equal(got_sel[0].numpy()[ok], sel[ok])
    assert 0 < ok.sum() < W


@pytest.mark.parametrize("kw,match", [
    ({"lm_lookahead": 3}, "item 4"),
    ({"reentry_topk": 4}, "item 4"),
    ({"reentry_preselect": 8}, "item 4"),
    ({"eq_depth_beam": 50.0}, "item 4"),
    ({"tp_state_beam": 50.0}, "item 4"),
])
def test_later_options_raise(kw, match):
    model, tree, fsa = make_decode_task()
    with pytest.raises(NotImplementedError, match=match):
        port_search(tree, fsa, model, JConfig(**kw))


def test_word_graph_names_the_lattice_item():
    """`word_graph` on a lattice=False result raises naming the flag; on
    a lattice=True result it is the reference's graph (the same nodes
    and arcs, scores within atol 2e-3)."""
    model, tree, fsa = make_decode_task()
    cfg = JConfig(num_tokens=16, lm_scale=2.0)
    obs = np.array(synth_obs(tree, model, ["a", "b", "b", "a"], seed=0))
    port = port_search(tree, fsa, model, cfg)
    with pytest.raises(RuntimeError, match="lattice=False"):
        port.decode(obs, lattice=False).word_graph()
    want = JBeamSearch(tree, fsa, model, cfg).decode(obs).word_graph()
    got = port.decode(obs).word_graph()
    assert [(n.index, n.frame) for n in got.nodes] == [
        (n.index, n.frame) for n in want.nodes]
    assert [(a.source, a.target, a.word) for a in got.arcs] == [
        (a.source, a.target, a.word) for a in want.arcs]
    for f in ("am", "lm"):
        np.testing.assert_allclose([getattr(a, f) for a in got.arcs],
                                   [getattr(a, f) for a in want.arcs],
                                   rtol=0, atol=2e-3)
    assert (got.start_node, got.end_node) == (want.start_node, want.end_node)
