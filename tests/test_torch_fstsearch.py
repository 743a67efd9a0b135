"""PyTorch port, FST decoding (`decoder/fstsearch.py`): every case of
`tests/test_fstsearch.py` and the buildable cases of
`tests/test_golden_fst.py` (the duration brute force, confidences, the
LNA interface) through both packages on the same inputs (CPU).  Words
and paths are identical; scores and confidences agree to rel 1e-5
(float32 sums in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aaltoasr_tpu.decoder import fstsearch as jfs
from aaltoasr_tpu.formats.lna import write_lna
from aaltoasr_tpu.models.hmm import TransitionTable as JTable

from aaltoasr_tpu_torch.decoder import fstsearch as tfs
from aaltoasr_tpu_torch.formats.fst import Fst, FstArc
from aaltoasr_tpu_torch.models.hmm import TransitionTable

from tests.test_fstsearch import word_loop_fst as j_word_loop_fst
from tests.test_golden_fst import CASES, _brute_force, make_fst, make_lna
from tests.test_golden_fst import make_model
from tests.test_train import three_state_model

torch.set_num_threads(1)

CPU = torch.device("cpu")


def word_loop_fst():
    """`tests/test_fstsearch.word_loop_fst` built with the port's classes."""
    fst = Fst()
    for a in j_word_loop_fst(None).arcs:
        fst.add_arc(FstArc(a.source, a.target, a.transition_index,
                           out_label=a.out_label))
    fst.initial = 0
    fst.final = 0
    return fst


def both(cls_name, n_fsts=1, **kw):
    """(JAX object, port object) of one decoder class on ``n_fsts`` word
    loops."""
    model = three_state_model()
    j = getattr(jfs, cls_name)(*[j_word_loop_fst(None)] * n_fsts,
                               model, JTable.from_model(model), **kw)
    t = getattr(tfs, cls_name)(*[word_loop_fst()] * n_fsts, model,
                               TransitionTable.from_model(model),
                               device=CPU, **kw)
    return model, j, t


def planted(model, seq, good=0.0, bad=-10.0):
    obs = np.full((len(seq), model.num_states), bad, dtype=np.float32)
    for t, s in enumerate(seq):
        obs[t, s] = good
    return obs


def random_obs(model, T, seed):
    return np.random.default_rng(seed).uniform(
        -9, -1, (T, model.num_states)).astype(np.float32)


def same_run(j, t, obs, n_frames=None):
    wj, sj, pj = j.run(obs, n_frames)
    wt, st, pt = t.run(obs, n_frames)
    n = obs.shape[0] if n_frames is None else n_frames
    assert wt == wj
    np.testing.assert_array_equal(np.asarray(pt)[:n], np.asarray(pj)[:n])
    assert st == pytest.approx(sj, rel=1e-5)
    return wt


@pytest.mark.parametrize("seq,words", [
    ([0, 0, 1, 2, 2, 2, 0, 0, 1], ["A", "B", "A"]),
    ([0, 0, 1, 1], ["A"]),
])
def test_fst_search_words_paths_scores(seq, words):
    model, j, t = both("FstSearch")
    assert same_run(j, t, planted(model, seq, bad=-8.0)) == words


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fst_search_random_observations(seed):
    """Ambiguous acoustics (no planted path), and a shorter n_frames."""
    model, j, t = both("FstSearch")
    obs = random_obs(model, 40, seed)
    same_run(j, t, obs)
    same_run(j, t, obs, n_frames=25)


def test_fst_search_lna_interface(tmp_path):
    model, j, t = both("FstSearch")
    p = tmp_path / "x.lna"
    write_lna(str(p), planted(model, [0, 0, 1, 1], bad=-8.0), 4)
    assert t.get_result_and_logprob(str(p)) == pytest.approx(
        j.get_result_and_logprob(str(p)), rel=1e-5)
    assert t.get_result_and_logprob(str(p))[0] == "A"


def test_clean_and_levenshtein():
    for s in ("A A B", "aabba", "", "abc  cba"):
        assert tfs._clean(s) == jfs._clean(s)
    for a, b in (("kitten", "sitting"), ("", "abc"), ("AB", "BA")):
        assert tfs._levenshtein(a, b) == jfs._levenshtein(a, b)


def _conf_obs(model, kind):
    good = planted(model, [0, 0, 1, 2, 2, 2, 0, 0, 1])
    if kind == "good":
        return good
    if kind == "bad":
        # acoustics prefer states the grammar path cannot follow well
        bad = np.random.default_rng(0).uniform(
            -9, -6, good.shape).astype(np.float32)
        bad[:, 2] = -1.0
        return bad
    return random_obs(model, 300, 7)          # a long path: the hash wraps


@pytest.mark.parametrize("kind", ["good", "bad", "long"])
def test_fst_confidence(kind):
    model, j, t = both("FstConfidence")
    obs = _conf_obs(model, kind)
    wj, sj, cj = j.run_with_confidence(obs)
    wt, st, ct = t.run_with_confidence(obs)
    assert wt == wj
    assert st == pytest.approx(sj, rel=1e-5)
    assert ct == pytest.approx(cj, rel=1e-5, abs=1e-6)
    assert t.token_conf == pytest.approx(j.token_conf, rel=1e-5, abs=1e-6)
    assert t.best_acu_conf == pytest.approx(j.best_acu_conf, rel=1e-5)
    # the reference's gaps between the winner and the best other
    # hypothesis, from its scan, against the port's
    jg, jd, ja = j._viterbi_with_hash(jnp.asarray(obs), obs.shape[0])
    tg, td, ta = t._viterbi_with_hash(torch.as_tensor(obs), obs.shape[0])
    assert (tg, td, ta) == pytest.approx((jg, jd, ja), rel=1e-5)


def test_hash_wraps_as_int32():
    """h * 31 + wid with two's-complement wrap, as XLA's int32 scan."""
    rng = np.random.default_rng(3)
    h = rng.integers(-2 ** 31, 2 ** 31, 1000, dtype=np.int64).astype(np.int32)
    wid = rng.integers(0, 1000004, 1000).astype(np.int32)
    with np.errstate(over="ignore"):
        want = h * np.int32(31) + wid
    got = tfs._hash_push(torch.as_tensor(h), torch.as_tensor(wid))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_phone_loop_variant(tmp_path):
    model, j, t = both("FstConfidenceWithPhoneLoop", 2)
    obs = planted(model, [0, 0, 1, 2, 2, 2, 0, 0, 1])
    p = tmp_path / "c.lna"
    lg = obs - np.log(np.exp(obs).sum(axis=1, keepdims=True))
    write_lna(str(p), lg.astype(np.float32), lna_bytes=4)
    rj, cj = j.result_and_confidence(str(p))
    rt, ct = t.result_and_confidence(str(p))
    assert rt == rj == "A B A"
    assert ct == pytest.approx(cj, rel=1e-5)
    assert t.edit_conf == pytest.approx(1.0)
    assert t.ploop_conf == pytest.approx(j.ploop_conf, rel=1e-5)


@pytest.mark.parametrize("dur_scale", [0.0, 3.0])
def test_mit_fst_duration_vs_brute_force(tmp_path, dur_scale):
    """The duration expansion against exhaustive token passing, and the
    JAX package's decoder on the same cases."""
    model = make_model(tmp_path)
    fst = make_fst(tmp_path)
    kw = dict(duration_scale=dur_scale, max_dur=16)
    j = jfs.MitFstSearch(fst, model, **kw)
    t = tfs.MitFstSearch(fst, model, device=CPU, **kw)
    for name, seq, seed in CASES:
        _, obs = make_lna(tmp_path, name, seq, seed=seed)
        bf_lp, bf_words = _brute_force(fst, model, obs.astype(np.float64),
                                       dur_scale)
        words = same_run(j, t, obs)
        assert tuple(words) == bf_words, (name, dur_scale)
        assert t.run(obs)[1] == pytest.approx(bf_lp, abs=1e-3)


@pytest.mark.parametrize("best_acu", [False, True])
def test_mit_fst_confidence(tmp_path, best_acu):
    model = make_model(tmp_path)
    fst = make_fst(tmp_path)
    j = jfs.MitFstSearch(fst, model)
    t = tfs.MitFstSearch(fst, model, device=CPU)
    for name, seq, seed in CASES + [("long.lna", None, 9)]:
        T = 200 if seq is None and name == "long.lna" else 12
        _, obs = make_lna(tmp_path, name, seq, T=T, seed=seed)
        wj, lj, cj = j.run_with_confidence(obs, accumulate_best_acu=best_acu)
        wt, lt, ct = t.run_with_confidence(obs, accumulate_best_acu=best_acu)
        assert wt == wj, name
        assert lt == pytest.approx(lj, rel=1e-5)
        assert ct == pytest.approx(cj, rel=1e-5, abs=1e-6), name


def test_mit_fst_lna_interface(tmp_path):
    model = make_model(tmp_path)
    fst = make_fst(tmp_path)
    lna, _ = make_lna(tmp_path, "x.lna",
                      [0, 0, 0, 1, 1, 1, 2, 2, 2, 0, 0, 1], seed=1)
    res, lp = tfs.MitFstSearch(fst, model, device=CPU).get_result_and_logprob(
        lna)
    want = jfs.MitFstSearch(fst, model).get_result_and_logprob(lna)
    assert res == want[0] == "yksi kaksi yksi"
    assert lp == pytest.approx(want[1], rel=1e-5)


@pytest.mark.parametrize("cls", [tfs.FstSearch, tfs.MitFstSearch])
def test_fst_decoders_default_to_cuda(monkeypatch, cls):
    """The decoders default to the GPU and, with none, raise before
    reading the network."""
    import inspect
    assert inspect.signature(cls).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls("no-network-read-before-the-device-check", None)
