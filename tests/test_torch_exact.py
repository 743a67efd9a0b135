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


def test_word_end_commit_rule(tmp_path):
    """`WordEnds` on the morph task of `test_morph_lm`, over hand-made LM
    states and words: the double-boundary prune, the sentence-end reset,
    a skip word, the final sentence-end walk and the record pointers."""
    from aaltoasr_tpu_torch.decoder.ngram import initial_code, reset_code
    from aaltoasr_tpu_torch.decoder.wordend import WordEnds, records
    make_morph_task(tmp_path)
    t = configure(Toolbox(str(tmp_path / "m.ph"), device="cpu"), tmp_path,
                  lex_name="our_lex.dict", silence_is_word=True,
                  optional_short_silence=True, word_boundary="<w>")
    lm = t.lm
    we = WordEnds(t.tree, lm, t.config)
    wb, end, ma = (t.tree.word_index[w] for w in ("<w>", "</s>", "ma"))
    s0 = initial_code(lm)
    s_wb = lm.walk(s0, lm.word_index["<w>"])[0]
    s_ma = lm.walk(s_wb, lm.word_index["ma"])[0]
    states = torch.tensor([[s_wb, s0, s_ma, s_wb, s_ma]])
    words = torch.tensor([[wb, wb, wb, end, ma]])
    skip = torch.tensor([[False, False, False, False, True]])
    nxt, sc = we.walk_words(states, words,
                            torch.as_tensor(we.lm_ids(words.numpy())))
    nxt2, sc2, ok = we.commit(states, words, nxt, sc, skip)
    # a <w> right after a <w> is pruned, after any other state kept
    assert ok.tolist() == [[False, True, True, True, True]]
    assert torch.equal(nxt2[0, :3], nxt[0, :3])
    assert torch.equal(sc2[0, :4], sc[0, :4])
    # </s> restarts the LM through <s> <w>
    assert int(nxt2[0, 3]) == reset_code(lm, "<w>") != int(nxt[0, 3])
    # a skip word keeps its state and scores 0
    assert int(nxt2[0, 4]) == s_ma and float(sc2[0, 4]) == 0.0
    end_id = lm.word_index["</s>"]
    np.testing.assert_allclose(
        we.end_score(states)[0].numpy(),
        [lm.walk(int(s), end_id)[1] for s in states[0]], rtol=1e-6)
    # records at step 3 of E = 3: a word points to itself, a silence
    # hands on its previous pointer, a dead end records nothing
    recs, ptr = records(torch.tensor([[True, True, False]]),
                        torch.tensor([[ma, -1, ma]]),
                        torch.tensor([[7, 5, 11]]), 3,
                        (torch.tensor([[1.5, 2.5, 3.5]]),))
    assert [r.tolist() for r in recs] == [[[ma, -1, -1]], [[7, -1, -1]],
                                          [[1.5, 0.0, 0.0]]]
    assert ptr.tolist() == [[9, 5, 11]]


@pytest.mark.parametrize("engine", ["exact", "dense"])
@pytest.mark.parametrize("split,in_lm,seq", [
    (True, False, ["ab_ca"]), (False, False, ["ab", "ca"]),
    (False, True, ["ab_ca"])])
def test_multiwords(tmp_path, split, in_lm, seq, engine):
    """Multiwords scored as their components (split) or as LM units:
    through both Toolboxes on the same files, or through both
    `DenseBeamSearch`es on the tree and LM those Toolboxes read."""
    from aaltoasr_tpu.decoder.search_dense import DenseBeamSearch as JDense
    from aaltoasr_tpu.formats.lna import read_lna
    from aaltoasr_tpu_torch.decoder.search_dense import DenseBeamSearch
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
    if engine == "exact":
        r = ref.lna_decode(lna)
        g = got.lna_decode(lna)
    else:
        lp = read_lna(lna)[0]
        r = JDense(ref.tree, ref.lm, ref.model, ref.config).decode(lp)
        port = DenseBeamSearch(got.tree, got.lm, got.model, got.config,
                               device="cpu")
        # the split task walks the LM component by component
        assert (port.wordend.mw_comp.shape[1] > 1) == split
        g = port.decode(lp)
    assert ("ab_ca" in r.words) == (seq == ["ab_ca"])
    assert_same(r, g)


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


@pytest.mark.parametrize("kw", [
    {"lm_lookahead": 3},
    {"reentry_topk": 4},
    {"reentry_preselect": 8},
    {"eq_depth_beam": 50.0},
    {"tp_state_beam": 50.0},
])
def test_later_options_raise(kw):
    """The options that once raised in the port (item 4) decode as the
    reference does on the monophone bigram task."""
    model, tree, fsa = make_decode_task()
    cfg = JConfig(num_tokens=24, num_records=8, beam=1e9, lm_scale=2.0,
                  require_sentence_end=True, **kw)
    obs, n = padded([np.array(synth_obs(tree, model, seq, frames_per_phone=2,
                                        noise=1.5, seed=seed))
                     for seed, seq in MONO_CASES])
    ref = JBeamSearch(tree, fsa, model, cfg).decode_batch(obs, n)
    got = port_search(tree, fsa, model, cfg).decode_batch(obs, n)
    for r, g in zip(ref, got):
        assert_same(r, g)


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


# ---- the rest of the exact engine's options -------------------------------

# context lookahead, compact and preselected re-entry and the pruning
# extensions on the 30-word cross-word task (fan networks, zero entry
# log-probs, a trigram LM); each pruning beam loose and tight
XW_OPTIONS = {
    "lookahead_3": {"lm_lookahead": 3},
    "lookahead_3_compact": {"lm_lookahead": 3, "overflow_tokens": 16,
                            "we_prewalk": 24, "reentry_records": 4,
                            "reentry_prewalk": 4},
    "reentry_topk": {"reentry_topk": 2},
    "reentry_topk_lookahead_3": {"reentry_topk": 2, "lm_lookahead": 3,
                                 "overflow_tokens": 16},
    "reentry_preselect": {"reentry_preselect": 6},
    "reentry_preselect_prewalk": {"reentry_preselect": 6,
                                  "reentry_prewalk": 3},
    "reentry_preselect_lookahead_3": {"reentry_preselect": 6,
                                      "lm_lookahead": 3},
    "eq_depth_loose": {"eq_depth_beam": 1e8},
    "eq_depth_tight": {"eq_depth_beam": 40.0},
    "eq_word_count_loose": {"eq_word_count_beam": 1e8},
    "eq_word_count_tight": {"eq_word_count_beam": 40.0},
    "fan_in_loose": {"fan_in_beam": 1e8},
    "fan_in_tight": {"fan_in_beam": 40.0},
    "fan_out_loose": {"fan_out_beam": 1e8},
    "fan_out_tight": {"fan_out_beam": 40.0},
    "tp_state_loose": {"tp_state_beam": 1e8, "num_tokens": 256},
    "tp_state_tight": {"tp_state_beam": 2.0, "num_tokens": 256},
    "all_beams_bench": {"eq_depth_beam": 60.0, "eq_word_count_beam": 60.0,
                        "fan_in_beam": 60.0, "fan_out_beam": 60.0,
                        "tp_state_beam": 30.0, "overflow_tokens": 16,
                        "we_prewalk": 24, "reentry_prewalk": 4},
}


@pytest.mark.parametrize("opt", list(XW_OPTIONS))
def test_crossword_options(xw_task, opt):
    model, tree, fsa, task, obs, n = xw_task
    kw = {"num_tokens": 64, "num_records": 16, **XW_OPTIONS[opt]}
    cfg = JConfig(lm_scale=30.0, duration_scale=3.0,
                  require_sentence_end=True, **kw)
    jref = JBeamSearch(tree, fsa, model, cfg)
    port = BeamSearch(task.tree, task.fsa, task.model,
                      convert.search_config(cfg), device="cpu")
    # the option engaged on both sides (no silent fallback)
    for a in ("_la_ctx", "_reentry_topk", "_reentry_pre"):
        assert getattr(port, a) == getattr(jref, a), a
    if "lm_lookahead" in kw:
        assert port._la_ctx
    if "reentry_topk" in kw:
        assert port._reentry_topk
    if "reentry_preselect" in kw:
        assert port._reentry_pre
    ref = jref.decode_batch(obs, n)
    got = port.decode_batch(obs, n)
    assert any(r.words for r in ref)
    for r, g in zip(ref, got):
        assert_same(r, g)


def test_tight_beams_prune(xw_task):
    """The tight settings of XW_OPTIONS prune: each changes the records
    of the search without the beam, where the loose ones keep them."""
    model, tree, fsa, task, obs, n = xw_task

    def records(**kw):
        cfg = convert.search_config(JConfig(**{
            "num_tokens": 64, "num_records": 16, "lm_scale": 30.0,
            "duration_scale": 3.0, "require_sentence_end": True, **kw}))
        res = BeamSearch(task.tree, task.fsa, task.model, cfg,
                         device="cpu").decode_batch(obs, n)
        return np.concatenate([r.rec_words.ravel() for r in res])

    for name, kw in XW_OPTIONS.items():
        if not name.endswith(("_tight", "_loose")):
            continue
        base = records(**{k: v for k, v in kw.items()
                          if not k.endswith("_beam")})
        if name.endswith("_tight"):
            assert (records(**kw) != base).any(), name
        else:
            np.testing.assert_array_equal(records(**kw), base)


def test_context_lookahead_tables(xw_task):
    """The per-state successor lists of context lookahead equal the
    reference's."""
    model, tree, fsa, task, _, _ = xw_task
    want = jsearch.context_lookahead_tables(
        tree, fsa, [fsa.word_index.get(w, -1) for w in tree.vocab])
    got = tsearch.context_lookahead_tables(
        task.tree, task.fsa,
        [task.fsa.word_index.get(w, -1) for w in task.tree.vocab])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert want["la_pos"].shape[1] > 1


@pytest.mark.parametrize("opt", ["lookahead_3", "lookahead_3_prewalk",
                                 "reentry_preselect"])
def test_trigram_options(opt):
    """Context lookahead (a three-level trigram walk) and the preselect
    on the monophone trigram task."""
    model, tree, fsa, _ = trigram_task()
    kw = {"lookahead_3": {"lm_lookahead": 3},
          "lookahead_3_prewalk": {"lm_lookahead": 3, "we_prewalk": 6,
                                  "overflow_tokens": 4},
          "reentry_preselect": {"reentry_preselect": 2,
                                "lm_lookahead": 1}}[opt]
    cfg = JConfig(num_tokens=64, num_records=16, beam=1e9, lm_scale=8.0,
                  duration_scale=0.0, require_sentence_end=True, **kw)
    obs, n = padded([np.array(synth_obs(tree, model, seq, noise=0.5,
                                        seed=seed))
                     for seed, seq in [(0, ["a", "b", "b", "a", "_"]),
                                       (1, ["a", "b", "c", "a"]),
                                       (2, ["b", "a", "c", "a", "_"])]])
    jref = JBeamSearch(tree, fsa, model, cfg)
    port = port_search(tree, fsa, model, cfg)
    assert port._la_ctx == jref._la_ctx == (cfg.lm_lookahead == 3)
    for r, g in zip(jref.decode_batch(obs, n), port.decode_batch(obs, n)):
        assert_same(r, g)


def test_reentry_topk_monophone_falls_back(capfd):
    """A monophone tree's single context row is not a (class, rcset)
    product: reentry_topk falls back to the full expansion with the
    reference's message, and decodes as the reference does."""
    model, tree, fsa = make_decode_task()
    cfg = JConfig(num_tokens=256, num_records=16, lm_scale=1.0,
                  reentry_topk=4)
    obs = np.array(synth_obs(tree, model, ["a", "b", "a"], seed=1))
    jref = JBeamSearch(tree, fsa, model, cfg)
    port = port_search(tree, fsa, model, cfg)
    assert port._reentry_topk == jref._reentry_topk
    err = capfd.readouterr().err
    if not port._reentry_topk:
        assert err.count("reentry_topk unavailable") == 2
    assert_same(jref.decode(obs), port.decode(obs))


def make_second_lm(vocab, bias_word):
    """A unigram ARPA LM strongly favouring one word."""
    from aaltoasr_tpu.formats.arpa import ArpaLM
    vocab = list(dict.fromkeys(["<s>", "</s>"] + list(vocab)))
    wi = {w: i for i, w in enumerate(vocab)}
    uni = {(wi[w],): (-0.15 if w == bias_word else -2.5, 0.0)
           for w in vocab}
    return ArpaLM(order=1, vocab=vocab, word_index=wi, ngrams=[{}, uni])


def inter_lm(bias="kaksi", coeffs=(0.5, 0.5)):
    from aaltoasr_tpu.decoder.ngram import InterNGramFsa as JInter
    from aaltoasr_tpu.formats.arpa import read_arpa as jread
    return JInter.from_arpas([jread(ARPA_TEXT),
                              make_second_lm(["yksi", "kaksi", "kolme"],
                                             bias)], list(coeffs))


def test_inter_walk():
    """The K-member walk (states as mixed-radix codes) against the
    reference's, on every (state pair, word); the host walk too."""
    from aaltoasr_tpu.decoder.ngram import lm_walk_device_multi as jmulti
    from aaltoasr_tpu_torch.decoder.ngram import lm_walk_device_multi
    ref = inter_lm(coeffs=(0.6, 0.4))
    port = convert.inter_ngram_fsa(ref)
    S0, S1 = (m.num_states for m in ref.members)
    st = np.array([(a, b) for a in range(S0) for b in range(S1)
                   for _ in range(ref.num_words)], np.int32)
    w = np.tile(np.arange(ref.num_words, dtype=np.int32), S0 * S1)
    jn, js = jmulti(ref, ref.member_tables(), jnp.asarray(st),
                    jnp.asarray(w))
    tn, ts = lm_walk_device_multi(port, port.member_tables(),
                                  torch.tensor(st, dtype=torch.int64),
                                  torch.tensor(w, dtype=torch.int64))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    code = port.encode(torch.tensor(st, dtype=torch.int64))
    np.testing.assert_array_equal(port.decode(code).numpy(), st)
    # codes order as the state tuples do
    assert (np.diff(code.numpy()) >= 0).all()
    for i in range(0, len(w), 7):
        assert port.walk(st[i], int(w[i])) == pytest.approx(
            ref.walk(st[i], int(w[i])))


def test_inter_union_vocab():
    """from_arpas maps every member onto the union vocabulary in the
    reference's order."""
    from aaltoasr_tpu.decoder.ngram import InterNGramFsa as JInter
    from aaltoasr_tpu_torch.decoder.ngram import InterNGramFsa
    from aaltoasr_tpu_torch.formats.arpa import ArpaLM as TArpa
    a1 = make_second_lm(["yksi", "kaksi", "kolme"], "kaksi")
    a2 = make_second_lm(["kolme", "neljä", "yksi"], "yksi")
    ref = JInter.from_arpas([a1, a2], [0.7, 0.3])
    got = InterNGramFsa.from_arpas(
        [TArpa(order=a.order, vocab=list(a.vocab),
               word_index=dict(a.word_index), ngrams=a.ngrams)
         for a in (a1, a2)], [0.7, 0.3])
    assert got.vocab == ref.vocab and got.word_index == ref.word_index
    for gm, rm in zip(got.members, ref.members):
        for f in ("trans_word", "trans_prob", "trans_next", "state_first",
                  "bo_weight", "bo_next"):
            np.testing.assert_array_equal(getattr(gm, f), getattr(rm, f))
    assert got.initial_state().tolist() == ref.initial_state().tolist()


@pytest.mark.parametrize("engine", ["exact", "dense"])
def test_inter_decode(engine):
    """Decoding with a two-member interpolated LM in both engines."""
    from aaltoasr_tpu.decoder.search_dense import DenseBeamSearch as JDense
    from aaltoasr_tpu_torch.decoder.search_dense import DenseBeamSearch
    model, tree, _ = make_decode_task()
    ref_lm = inter_lm()
    cfg = JConfig(num_tokens=64, num_records=16, beam=1e9, lm_scale=2.0,
                  require_sentence_end=True)
    obs, n = padded([np.array(synth_obs(tree, model, seq, noise=1.0,
                                        seed=seed))
                     for seed, seq in MONO_CASES])
    args = (convert.prefix_tree(tree), convert.inter_ngram_fsa(ref_lm),
            convert.hmm_model(model), convert.search_config(cfg))
    if engine == "exact":
        ref = JBeamSearch(tree, ref_lm, model, cfg).decode_batch(obs, n)
        got = BeamSearch(*args, device="cpu").decode_batch(obs, n)
        for r, g in zip(ref, got):
            assert_same(r, g)
        return
    ref = JDense(tree, ref_lm, model, cfg).decode_batch(obs, n)
    got = DenseBeamSearch(*args, device="cpu").decode_batch(obs, n)
    for r, g in zip(ref, got):
        assert_same(r, g)


CLASS_ARPA = ARPA_TEXT.replace("ngram 1=5", "ngram 1=4").replace(
    "ngram 2=6", "ngram 2=5").split("\\1-grams:")[0] + """\\1-grams:
-0.7 </s>
-99 <s> -0.6
-0.4 NUM -0.3
-0.9 kolme -0.2

\\2-grams:
-0.3 <s> NUM
-0.2 NUM NUM
-0.8 NUM kolme
-0.4 kolme NUM
-0.5 NUM </s>

\\end\\
"""
CLASSES = "NUM 0.3 yksi\nNUM 0.7 kaksi\n"


@pytest.mark.parametrize("engine", ["exact", "dense"])
def test_word_classes(engine):
    """Class-based decoding: the class is the LM word, the membership
    log-prob joins the pronunciation score.  The reference edits its
    tree in place, so the port gets a copy taken before the reference
    search is built."""
    from aaltoasr_tpu.decoder.classes import WordClasses as JClasses
    from aaltoasr_tpu.decoder.search_dense import DenseBeamSearch as JDense
    from aaltoasr_tpu_torch.decoder.search_dense import DenseBeamSearch
    model, tree, _ = make_decode_task()
    fsa = NGramFsa.from_arpa(read_arpa(CLASS_ARPA))
    wc = JClasses.read(CLASSES)
    cfg = JConfig(num_tokens=64, num_records=16, beam=1e9, lm_scale=2.0,
                  require_sentence_end=True)
    obs, n = padded([np.array(synth_obs(tree, model, seq, noise=1.0,
                                        seed=seed))
                     for seed, seq in MONO_CASES])
    args = (convert.prefix_tree(tree), convert.ngram_fsa(fsa),
            convert.hmm_model(model), convert.search_config(cfg))
    pron = np.array(tree.we_pron_logp)
    cls_j, cls_t = (JBeamSearch, BeamSearch) if engine == "exact" else (
        JDense, DenseBeamSearch)
    ref = cls_j(tree, fsa, model, cfg, word_classes=wc).decode_batch(obs, n)
    port = cls_t(*args, word_classes=convert.word_classes(wc), device="cpu")
    np.testing.assert_array_equal(port.tree.we_pron_logp, pron)
    got = port.decode_batch(obs, n)
    assert any({"yksi", "kaksi"} & set(r.words) for r in ref)
    for r, g in zip(ref, got):
        assert_same(r, g)


# ---- every Toolbox call the port added, against the reference's ------------

def _golden_files(tmp_path):
    """The golden monophone task's files, a second LM, word classes over
    its vocabulary and two LNAs."""
    from tests.test_golden_decode import make_task
    from aaltoasr_tpu.formats.arpa import write_arpa
    model, lex, _ = make_task(tmp_path)
    words = sorted(lex)
    write_arpa(make_second_lm(words, words[1]), str(tmp_path / "lm2.arpa"))
    (tmp_path / "classes").write_text(
        f"{words[0]} 1.0 {words[0]}\n{words[1]} 0.5 {words[1]}\n")
    lnas = [synth_lna(tmp_path, model, lex, seq, seed=7 + i, noise=0.6,
                      name=f"u{i}.lna")
            for i, seq in enumerate([words[:3], words[1:4][::-1]])]
    return model, lnas


TOOLBOX_CALLS = {
    "fsa_lm_read": [("fsa_lm_read", "@lm.arpa")],
    "interpolated_ngram_read": [
        ("interpolated_ngram_read", ["@lm.arpa", "@lm2.arpa"], [0.7, 0.3])],
    "interpolated_lookahead_ngram_read": [
        ("interpolated_lookahead_ngram_read", ["@lm.arpa", "@lm2.arpa"],
         [0.5, 0.5]), ("set_lm_lookahead", 1)],
    "hmm_read": [("hmm_read", "@m.ph"), ("lex_read", "@lex.dict")],
    "read_word_classes": [("read_word_classes", "@classes")],
    "set_transition_scale": [("set_transition_scale", 2.0)],
    "set_cross_word_triphones": [("set_cross_word_triphones", False),
                                 ("lex_read", "@lex.dict")],
    "set_lm_lookahead_3": [("set_lm_lookahead", 3)],
    "pruning_beams": [("set_eq_depth_beam", 60.0),
                      ("set_eq_word_count_beam", 60.0),
                      ("set_fan_in_beam", 60.0), ("set_fan_out_beam", 60.0),
                      ("set_tp_state_beam", 30.0)],
    "set_sentence_boundary": [("set_sentence_boundary", "</s>", "</s>"),
                              ("set_require_sentence_end", True)],
    "set_end": [("set_end", 9)],
    "parity_flags": [("set_ignore_case", True), ("lex_read", "@lex.dict"),
                     ("set_prune_similar", 3),
                     ("set_use_word_pair_approximation", True),
                     ("set_use_lm_cache", True),
                     ("prune_lm_lookahead_buffers", 0.1, 4),
                     ("set_remove_pronunciation_id", True),
                     ("set_verbose", 1), ("set_print_probs", True),
                     ("set_print_text_result", True)],
}


@pytest.mark.parametrize("case", list(TOOLBOX_CALLS))
def test_toolbox_calls(tmp_path, case):
    """Each new Toolbox call, made on both packages' Toolboxes over the
    same files: the same decodes of two LNAs.  ``@name`` is a file of
    the task."""
    from aaltoasr_tpu.formats.model_io import write_dur
    model, lnas = _golden_files(tmp_path)
    write_dur(str(tmp_path / "m.dur"),
              np.array([(2.0 + 0.5 * (s % 3), 1.5)
                        for s in range(model.num_states)]))

    def arg(a):
        if isinstance(a, str) and a.startswith("@"):
            return str(tmp_path / a[1:])
        if isinstance(a, list):
            return [arg(x) for x in a]
        return a

    def setup(t):
        t.set_lm_scale(10.0)
        t.set_global_beam(300.0)
        t.set_silence_is_word(False)
        t.set_require_sentence_end(True)
        t.lex_read(str(tmp_path / "lex.dict"))
        t.ngram_read(str(tmp_path / "lm.arpa"))
        t.duration_read(str(tmp_path / "m.dur"))
        for name, *args in TOOLBOX_CALLS[case]:
            getattr(t, name)(*[arg(a) for a in args])
        return t

    ref = setup(JToolbox(str(tmp_path / "m.ph")))
    got = setup(Toolbox(str(tmp_path / "m.ph"), device="cpu"))
    assert got.config == convert.search_config(ref.config)
    for lna in lnas:
        assert_same(ref.lna_decode(lna), got.lna_decode(lna))


def test_toolbox_streaming_calls(tmp_path):
    """use_one_frame_acoustics / set_one_frame / run / stream_result on
    both Toolboxes."""
    from aaltoasr_tpu.formats.lna import read_lna as jread_lna
    model, lnas = _golden_files(tmp_path)
    lp, _ = jread_lna(lnas[0])
    out = []
    for t in (JToolbox(str(tmp_path / "m.ph")),
              Toolbox(str(tmp_path / "m.ph"), device="cpu")):
        t.set_lm_scale(10.0)
        t.set_silence_is_word(False)
        t.lex_read(str(tmp_path / "lex.dict"))
        t.ngram_read(str(tmp_path / "lm.arpa"))
        assert not t.run()
        t.use_one_frame_acoustics()
        for f in range(lp.shape[0]):
            t.set_one_frame(f, lp[f])
        assert t.run()
        out.append(t.stream_result())
    assert out[1].words == out[0].words and out[0].words
    assert out[1].log_prob == pytest.approx(out[0].log_prob, rel=RTOL,
                                            abs=ATOL)


def test_word_classes_rebuild_quirk(tmp_path):
    """The reference's `WordClasses.apply_to_tree` edits the tree in
    place, so its Toolbox adds the membership log-probs again each time
    a setter rebuilds the search.  The port matches the reference's
    first build and stays there on a rebuild."""
    from aaltoasr_tpu.formats.arpa import write_arpa
    model, lnas = _golden_files(tmp_path)
    res = {}
    for name, t in (("ref", JToolbox(str(tmp_path / "m.ph"))),
                    ("port", Toolbox(str(tmp_path / "m.ph"),
                                     device="cpu"))):
        t.set_lm_scale(10.0)
        t.set_silence_is_word(False)
        t.lex_read(str(tmp_path / "lex.dict"))
        t.ngram_read(str(tmp_path / "lm.arpa"))
        t.read_word_classes(str(tmp_path / "classes"))
        first = t.lna_decode(lnas[0])
        t.set_lm_scale(10.0)                  # rebuilds the search
        res[name] = (first, t.lna_decode(lnas[0]))
    assert_same(res["ref"][0], res["port"][0])
    assert_same(res["port"][0], res["port"][1])
    # the reference's second build paid ln(0.5) once more per member word
    assert res["ref"][1].final_lms < res["ref"][0].final_lms - 0.5


def test_recombination_unfused_key():
    """Without the fused int64 key (node x state codes too wide) the two
    extra stable sorts keep the reference's order."""
    rng = np.random.default_rng(7)
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
        torch.tensor(total)[None], torch.tensor(alive)[None], S, W,
        fused_key=False)
    np.testing.assert_array_equal(got_ok[0].numpy(), ok)
    np.testing.assert_array_equal(got_sel[0].numpy()[ok], sel[ok])
