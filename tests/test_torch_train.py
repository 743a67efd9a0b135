"""PyTorch port, ML training: chains, the batched E-step (forward-backward
and Viterbi, plain and shift-compiled), `chain_stats`, the accumulators'
dumps, the host M-step copies and `EStepDriver`, each against the JAX
package on the same numpy inputs (CPU).  Tolerances are the JAX
package's own (`tests/test_train.py`, `tests/test_golden_stats.py`):
Viterbi paths identical, FB gamma atol 2e-4, transitions rtol 2e-3 /
atol 2e-4, totals rel 1e-5, dumps within the golden-stats tolerances
relative to scale; the host copies give byte-identical files."""

import wave

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aaltoasr_tpu.formats import model_io as j_mio
from aaltoasr_tpu.models import hmm as j_hmm
from aaltoasr_tpu.models.hmmnet import (
    compile_hmmnet, pad_hmmnet, transcript_hmmnet, union_fst)
from aaltoasr_tpu.ops import chain as j_chain
from aaltoasr_tpu.ops.gmm import GmmScorer as JScorer
from aaltoasr_tpu.ops.logsemiring import segment_logsumexp as j_seglse
from aaltoasr_tpu.train import accumulators as j_acc
from aaltoasr_tpu.train import driver as j_driver
from aaltoasr_tpu.train import durations as j_dur
from aaltoasr_tpu.train import ebw as j_ebw
from aaltoasr_tpu.train import estep as j_estep
from aaltoasr_tpu.train import estimate as j_estimate
from aaltoasr_tpu.train import gcluster as j_gcluster
from aaltoasr_tpu.train import mllt as j_mllt
from aaltoasr_tpu.train import split as j_split

from aaltoasr_tpu_torch import convert
from aaltoasr_tpu_torch.formats import model_io as t_mio
from aaltoasr_tpu_torch.models import hmm as t_hmm
from aaltoasr_tpu_torch.ops import chain as t_chain
from aaltoasr_tpu_torch.ops.logsemiring import segment_logsumexp as t_seglse
from aaltoasr_tpu_torch.train import accumulators as t_acc
from aaltoasr_tpu_torch.train import driver as t_driver
from aaltoasr_tpu_torch.train import durations as t_dur
from aaltoasr_tpu_torch.train import ebw as t_ebw
from aaltoasr_tpu_torch.train import estep as t_estep
from aaltoasr_tpu_torch.train import estimate as t_estimate
from aaltoasr_tpu_torch.train import gcluster as t_gcluster
from aaltoasr_tpu_torch.train import mllt as t_mllt
from aaltoasr_tpu_torch.train import split as t_split

from tests.test_train import np_viterbi, three_state_model

torch.set_num_threads(1)

# golden-stats tolerances, relative to each array's scale
# (tests/test_golden_stats.py:140-145)
STATS_TOL = [("gamma", 1e-6), ("mean_acc", 1e-4), ("sec_acc", 1e-4),
             ("aux_gamma", 1e-6), ("mix_gamma", 1e-6), ("mix_ll", 1e-5)]


def _jg(g):
    return {k: jnp.asarray(v) for k, v in g.items()}


def _tg(*gs):
    return t_estep.stack_graphs(list(gs), "cpu")


def _jbatch(fn, obs, graphs, ns, *args, **kw):
    """The reference function on each utterance of a batch, in one
    vmapped call (one compile): obs [B, ...], one graph dict per
    utterance (same shapes), ns [B]."""
    import jax
    stacked = {k: jnp.stack([jnp.asarray(g[k]) for g in graphs])
               for k in graphs[0]}
    return jax.vmap(lambda o, g, n: fn(o, g, n, *args, **kw))(
        jnp.asarray(obs), stacked, jnp.asarray(ns, jnp.int32))


def _n(*n):
    return torch.as_tensor(n)


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _models(seed=0):
    jm = three_state_model(seed=seed)
    return jm, convert.hmm_model(jm)


def _chain_graph(seed, labels=("a", "_", "a"), extra=3):
    jm = three_state_model(seed=seed)
    table = j_hmm.TransitionTable.from_model(jm)
    c = j_hmm.build_chain(jm, table, list(labels))
    return j_hmm.pad_chain(c, c.num_positions + extra, fan=4), table, c


def _hmmnet_graph(seed, seqs=(("a", "_"), ("_", "a", "a"))):
    """A union of two transcript networks: arcs with irregular edges,
    explicit entry/final vectors and per-arc constants."""
    jm = three_state_model(seed=seed)
    table = j_hmm.TransitionTable.from_model(jm)
    fst = union_fst(transcript_hmmnet(jm, table, list(seqs[0])),
                    transcript_hmmnet(jm, table, list(seqs[1])))
    g, _ = compile_hmmnet(fst, table)
    return pad_hmmnet(g, int(g["num_positions"]) + 2, fan=6), table


def _graph(kind, seed):
    if kind == "chain":
        g, table, _ = _chain_graph(seed)
    else:
        g, table = _hmmnet_graph(seed)
    return g, table


def _obs(g, T, seed):
    rng = np.random.default_rng(seed)
    P = g["pdf"].shape[0]
    obs = rng.normal(-3, 1.5, (T, P)).astype(np.float32)
    if "obs_const" in g:
        obs = obs + np.asarray(g["obs_const"])[None, :]
    return obs


def _close_scaled(a, b, rtol, name=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.max(np.abs(a))), 1e-9) if a.size else 1.0
    assert float(np.max(np.abs(a - b), initial=0.0)) <= rtol * scale, name


# -- chains and tables --------------------------------------------------------

@pytest.mark.parametrize("labels,pad,fan", [
    (("a", "_", "a"), 0, 0), (("_", "a", "a", "_"), 5, 4), (("a",), 2, 4)])
def test_chain_tables_identical(labels, pad, fan):
    """TransitionTable, LinearChain, pad_chain and shift_compile arrays
    are identical (the .phs dumps line up slot by slot)."""
    jm, tm = _models(seed=2)
    jt = j_hmm.TransitionTable.from_model(jm)
    tt = t_hmm.TransitionTable.from_model(tm)
    for f in ("source", "offset", "prob", "state_first", "state_count"):
        np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f))
        np.testing.assert_array_equal(
            getattr(convert.transition_table(jt), f), getattr(jt, f))
    jc = j_hmm.build_chain(jm, jt, list(labels))
    tc = t_hmm.build_chain(tm, tt, list(labels))
    cc = convert.linear_chain(jc)
    for f in ("pdf", "phone_index", "state_in_phone", "edge_src",
              "edge_tgt", "edge_logp", "edge_slot"):
        np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f))
        np.testing.assert_array_equal(getattr(cc, f), getattr(jc, f))
    assert (tc.final_logp, tc.final_slot) == (jc.final_logp, jc.final_slot)
    jp = j_estep.shift_compile(j_hmm.pad_chain(jc, jc.num_positions + pad,
                                               fan=fan))
    tp = t_estep.shift_compile(t_hmm.pad_chain(tc, tc.num_positions + pad,
                                               fan=fan))
    assert sorted(jp) == sorted(tp)
    for k in jp:
        assert np.asarray(tp[k]).dtype == np.asarray(jp[k]).dtype, k
        np.testing.assert_array_equal(tp[k], jp[k], err_msg=k)


def test_shift_compile_hmmnet_identical():
    g, _ = _hmmnet_graph(seed=21)
    jp, tp = j_estep.shift_compile(g), t_estep.shift_compile(g)
    assert len(tp["ir_src"]) > 1              # irregular edges present
    for k in jp:
        np.testing.assert_array_equal(tp[k], jp[k], err_msg=k)


def test_stack_graphs_pads_irregular_lists():
    a = t_estep.shift_compile(_chain_graph(1)[0])
    b = t_estep.shift_compile(_chain_graph(1)[0])
    b = dict(b, ir_src=np.asarray([1, 2], np.int32),
             ir_tgt=np.asarray([3, 4], np.int32),
             ir_logp=np.asarray([-1.0, -2.0], np.float32),
             ir_slot=np.asarray([1, 1], np.int32))
    st = _tg(a, b)
    assert st["ir_src"].shape == (2, 2) and st["ir_src"].dtype == torch.int64
    assert float(st["ir_logp"][0, 1]) == float(np.float32(t_estep.LOG_ZERO))
    assert st["num_positions"].shape == (2,)


# -- Viterbi ------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["chain", "hmmnet"])
@pytest.mark.parametrize("shift", [False, True])
def test_viterbi_paths_identical(kind, shift):
    """masked_viterbi / masked_viterbi_shift: the same path as the
    reference's, masked frames included; scores rel 1e-5."""
    g, _ = _graph(kind, seed=21)
    if shift:
        g = j_estep.shift_compile(g)
    jv = j_estep.masked_viterbi_shift if shift else j_estep.masked_viterbi
    tv = t_estep.masked_viterbi_shift if shift else t_estep.masked_viterbi
    obs = np.stack([_obs(g, 14, s) for s in (1, 2, 3)])
    ns = (10, 14, 9)
    tp, ts = tv(torch.as_tensor(obs), _tg(g, g, g), _n(*ns))
    jp, js = _jbatch(jv, obs, [g] * 3, ns)
    np.testing.assert_array_equal(_np(tp), np.asarray(jp))
    np.testing.assert_allclose(_np(ts), np.asarray(js), rtol=1e-5)


def test_viterbi_ties_follow_the_reference():
    """Equal candidates everywhere: every tie breaks as the reference's
    (first shift class, first fan-in slot, largest irregular edge)."""
    g, _ = _hmmnet_graph(seed=22)
    g = j_estep.shift_compile(g)
    g = dict(g, sh_logp=np.where(g["sh_logp"] > -1e29, -1.0,
                                 g["sh_logp"]).astype(np.float32),
             ir_logp=np.full_like(g["ir_logp"], -1.0),
             in_logp=np.where(g["in_logp"] > -1e29, -1.0,
                              g["in_logp"]).astype(np.float32))
    obs = np.zeros((12, g["pdf"].shape[0]), np.float32)
    for jv, tv in ((j_estep.masked_viterbi, t_estep.masked_viterbi),
                   (j_estep.masked_viterbi_shift,
                    t_estep.masked_viterbi_shift)):
        jp, _ = jv(jnp.asarray(obs), _jg(g), jnp.int32(12))
        tp, _ = tv(torch.as_tensor(obs)[None], _tg(g), _n(12))
        np.testing.assert_array_equal(_np(tp[0]), np.asarray(jp))


def test_viterbi_chain_matches_reference_and_bruteforce():
    g, table, c = _chain_graph(seed=4, labels=("a", "_"), extra=0)
    obs = _obs(g, 8, seed=5)
    tp, ts = t_chain.viterbi_chain(torch.as_tensor(obs), g)
    jp, js = j_chain.viterbi_chain(jnp.asarray(obs), _jg(g))
    np.testing.assert_array_equal(_np(tp), np.asarray(jp))
    assert float(ts) == pytest.approx(float(js), rel=1e-5)
    want, score = np_viterbi(obs.astype(np.float64), c)
    np.testing.assert_array_equal(_np(tp), want)
    assert float(ts) == pytest.approx(score, rel=1e-5)


# -- forward-backward ---------------------------------------------------------

@pytest.mark.parametrize("kind", ["chain", "hmmnet"])
@pytest.mark.parametrize("shift", [False, True])
def test_fb_matches_reference(kind, shift):
    """Gamma atol 2e-4, transitions rtol 2e-3 / atol 2e-4, totals rel
    1e-5, the structural liveness mask identical; three utterances of
    different lengths in one batch."""
    g, table = _graph(kind, seed=13)
    if shift:
        g = j_estep.shift_compile(g)
    jf = (j_estep.masked_forward_backward_shift if shift
          else j_estep.masked_forward_backward)
    tf = (t_estep.masked_forward_backward_shift if shift
          else t_estep.masked_forward_backward)
    obs = np.stack([_obs(g, 12, s) for s in (14, 15, 16)])
    ns = (12, 7, 10)
    tga, tta, tla, tlive = tf(torch.as_tensor(obs), _tg(g, g, g), _n(*ns),
                              table.num_slots, with_live=True)
    ga, ta, la, live = _jbatch(jf, obs, [g] * 3, ns, table.num_slots,
                               with_live=True)
    np.testing.assert_allclose(_np(tla), np.asarray(la), rtol=1e-5)
    np.testing.assert_allclose(_np(tga), np.asarray(ga), atol=2e-4)
    np.testing.assert_allclose(_np(tta), np.asarray(ta), rtol=2e-3, atol=2e-4)
    np.testing.assert_array_equal(_np(tlive), np.asarray(live))


def test_fb_padding_invariance():
    """More positions and fan: gamma, transitions and total unchanged
    (`tests/test_train.py::test_padding_invariance`)."""
    _, table, c = _chain_graph(seed=0, labels=("a", "_"))
    rng = np.random.default_rng(42)
    obs1 = rng.normal(-3, 1.5, (10, 3)).astype(np.float32)
    obs2 = np.concatenate([obs1, np.full((10, 5), -1.0, np.float32)], 1)
    g1 = t_hmm.pad_chain(c, 3)
    g2 = t_hmm.pad_chain(c, 8, fan=4)
    gm1, tp1, t1 = t_estep.masked_forward_backward(
        torch.as_tensor(obs1)[None], _tg(g1), _n(10), table.num_slots)
    gm2, tp2, t2 = t_estep.masked_forward_backward(
        torch.as_tensor(obs2)[None], _tg(g2), _n(10), table.num_slots)
    assert float(t1) == pytest.approx(float(t2), rel=1e-6)
    np.testing.assert_allclose(_np(gm2[0])[:, :3], _np(gm1[0]), atol=1e-5)
    np.testing.assert_allclose(_np(tp1), _np(tp2), atol=1e-4)


@pytest.mark.parametrize("shift", [False, True])
def test_fb_time_mask_invariance(shift):
    """Frames past n_frames change nothing and carry zero gamma.  The
    transitions too: the reference's come out NaN here (a masked term
    overflows and is multiplied by 0), the port's select 0."""
    g, table, _ = _chain_graph(seed=15)
    if shift:
        g = t_estep.shift_compile(g)
    fb = (t_estep.masked_forward_backward_shift if shift
          else t_estep.masked_forward_backward)
    obs = _obs(g, 10, seed=16)
    obs2 = obs.copy()
    obs2[6:] = 99.0
    ga, ta, la = fb(torch.as_tensor(obs)[None], _tg(g), _n(6),
                    table.num_slots)
    gb, tb, lb = fb(torch.as_tensor(obs2)[None], _tg(g), _n(6),
                    table.num_slots)
    assert float(la) == pytest.approx(float(lb))
    np.testing.assert_allclose(_np(ga), _np(gb), atol=1e-6)
    np.testing.assert_allclose(_np(ta), _np(tb), atol=1e-6)
    assert float(gb[0, 6:].sum()) == 0.0


def test_forward_backward_chain_and_assoc_scan():
    """ops/chain.py against the reference, and the log-depth prefix scan
    against the sequential forward (`tests/test_assoc_scan.py`)."""
    g, table, _ = _chain_graph(seed=0, labels=("_", "a", "a", "_"),
                               extra=3)
    obs = _obs(g, 19, seed=3)
    tg_, tt, tl = t_chain.forward_backward_chain(torch.as_tensor(obs), g,
                                                 table.num_slots)
    jg_, jt, jl = j_chain.forward_backward_chain(jnp.asarray(obs), _jg(g),
                                                 table.num_slots)
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    np.testing.assert_allclose(_np(tg_), np.asarray(jg_), atol=2e-4)
    np.testing.assert_allclose(_np(tt), np.asarray(jt), rtol=2e-3, atol=2e-4)
    alphas, total = t_chain.forward_assoc_chain(torch.as_tensor(obs), g)
    assert float(total) == pytest.approx(float(tl), rel=1e-5)
    # a fresh sequential forward, frame by frame
    from aaltoasr_tpu_torch.ops.logsemiring import logsumexp
    in_src = torch.as_tensor(g["in_src"]).long()
    in_logp = torch.as_tensor(g["in_logp"])
    o = torch.as_tensor(obs)
    a = torch.clamp(o[0] + t_chain._entry_vector(o.shape[1], "cpu"), min=-1e30)
    for t in range(1, o.shape[0]):
        a = torch.clamp(logsumexp(a[in_src] + in_logp, dim=1) + o[t],
                        min=-1e30)
        live = _np(a) > -1e29
        np.testing.assert_allclose(_np(alphas[t])[live], _np(a)[live],
                                   rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(
        _np(t_chain.dense_transition_matrix(g)),
        np.asarray(j_chain.dense_transition_matrix(g)))
    path = torch.as_tensor([0, 1, 1, 2])
    np.testing.assert_array_equal(
        _np(t_chain.occupancies_from_alignment(path, 4)),
        np.asarray(j_chain.occupancies_from_alignment(jnp.asarray(path), 4)))


def test_segment_logsumexp_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 3, 40).astype(np.float32)
    x[:5] = -1e30
    ids = rng.integers(0, 9, 40)
    ids[:5] = 8                                   # an all-dead segment
    got = t_seglse(torch.as_tensor(x), torch.as_tensor(ids), 10)
    want = j_seglse(jnp.asarray(x), jnp.asarray(ids), 10)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6)


# -- chain_stats --------------------------------------------------------------

def _stats_close(t, j, name=""):
    """Device statistics of one utterance against the reference's."""
    for k in j:
        a, b = np.asarray(j[k], np.float64), np.asarray(t[k], np.float64)
        if k in ("feacount", "num_frames"):
            np.testing.assert_array_equal(b, a, err_msg=f"{name} {k}")
        elif k == "log_likelihood":
            assert float(b) == pytest.approx(float(a), rel=1e-5), name
        else:
            _close_scaled(a, b, 1e-4 if "acc" in k else 2e-5, f"{name} {k}")


@pytest.mark.parametrize("mode,full,shift", [
    ("bw", False, True), ("bw", True, False), ("vit", False, True),
    ("vit", True, False)])
def test_chain_stats_matches_reference(mode, full, shift):
    """Per utterance and as one padded batch of three (different
    lengths), against the reference's `chain_stats` per utterance."""
    jm, tm = _models(seed=3)
    js = JScorer.from_model(jm)
    ts = convert.gmm_scorer(js)
    table = j_hmm.TransitionTable.from_model(jm)
    graphs = []
    for labels in (("a", "_"), ("_", "a", "_"), ("a", "a")):
        c = j_hmm.build_chain(jm, table, list(labels))
        g = j_hmm.pad_chain(c, 8, fan=4)
        graphs.append(j_estep.shift_compile(g) if shift else g)
    rng = np.random.default_rng(7)
    X = rng.normal(0, 2, (3, 16, jm.dim)).astype(np.float32)
    ns = (16, 11, 13)
    out = t_estep.chain_stats(ts, torch.as_tensor(X), _tg(*graphs), _n(*ns),
                              table.num_slots, mode=mode, full_stats=full)
    want = _jbatch(lambda f, g, n: j_estep.chain_stats(
        js, f, g, n, table.num_slots, mode=mode, full_stats=full),
        X, graphs, ns)
    for b in range(3):
        _stats_close({k: _np(v[b]) for k, v in out.items()},
                     {k: np.asarray(v)[b] for k, v in want.items()},
                     f"{mode} utt {b}")
    if mode == "bw":
        assert float(out["gamma"][0].sum()) == pytest.approx(16, rel=1e-4)
    # batch_chain_stats: the same statistics summed over the batch
    summed = t_estep.batch_chain_stats(ts, torch.as_tensor(X), _tg(*graphs),
                                       _n(*ns), table.num_slots, mode=mode)
    for k, v in summed.items():
        np.testing.assert_allclose(_np(v), _np(out[k].sum(0)), rtol=1e-6,
                                   atol=1e-5)


@pytest.mark.parametrize("mode", ["bw", "vit"])
def test_chain_stats_on_hmmnet_graph(mode):
    """Graphs with explicit entry/final vectors, per-arc constants and
    arc slots go through the same code as the reference's."""
    g, table = _hmmnet_graph(seed=31)
    g = j_estep.shift_compile(g)
    jm, tm = _models(seed=31)
    js = JScorer.from_model(jm)
    X = np.random.default_rng(2).normal(0, 2, (12, jm.dim)).astype(np.float32)
    want = j_estep.chain_stats(js, jnp.asarray(X), _jg(g), jnp.int32(12),
                               table.num_slots, mode=mode)
    got = t_estep.chain_stats(convert.gmm_scorer(js), torch.as_tensor(X)[None],
                              _tg(g), _n(12), table.num_slots, mode=mode)
    _stats_close({k: _np(v[0]) for k, v in got.items()}, want, mode)


@pytest.mark.parametrize("kw", [dict(mode="mpv"), dict(arc_feacount=True)])
def test_chain_stats_hmmnet_options_raise(kw):
    """The hmmnet options of `chain_stats` (once refused, now ported):
    multipath Viterbi and the per-arc feature counts on a JAX-compiled
    network, against the reference's (`_stats_close`)."""
    g, table = _hmmnet_graph(seed=32)
    jm, _ = _models(seed=32)
    js = JScorer.from_model(jm)
    X = np.random.default_rng(3).normal(0, 2, (10, jm.dim)).astype(np.float32)
    want = j_estep.chain_stats(js, jnp.asarray(X), _jg(g), jnp.int32(10),
                               table.num_slots, **kw)
    got = t_estep.chain_stats(convert.gmm_scorer(js), torch.as_tensor(X)[None],
                              _tg(g), _n(10), table.num_slots, **kw)
    _stats_close({k: _np(v[0]) for k, v in got.items()}, want, str(kw))


def test_em_increases_likelihood():
    """EM through the port's E-step and M-step raises the likelihood
    (`tests/test_train.py::test_em_increases_likelihood`)."""
    true_model = convert.hmm_model(three_state_model(seed=10))
    table = t_hmm.TransitionTable.from_model(true_model)
    chain = t_hmm.build_chain(true_model, table, ["a", "_"])
    g = _tg(t_hmm.pad_chain(chain, chain.num_positions))
    rng = np.random.default_rng(11)
    T = 120
    pos, seq = 0, []
    for _ in range(T):
        seq.append(pos)
        if pos < 2 and rng.uniform() < 0.45:
            pos += 1
    X = np.zeros((T, true_model.dim), np.float32)
    for t, p in enumerate(seq):
        idx, w = true_model.mixtures[int(chain.pdf[min(p, 2)])]
        k = idx[rng.choice(len(idx), p=w)]
        X[t] = rng.normal(true_model.means[k], np.sqrt(true_model.covars[k]))
    from aaltoasr_tpu_torch.ops.gmm import GmmScorer
    model = convert.hmm_model(three_state_model(seed=99))
    lls = []
    for _ in range(4):
        out = t_driver.fetch(t_estep.chain_stats(
            GmmScorer.from_model(model, device="cpu"),
            torch.as_tensor(X)[None], g, _n(T), table.num_slots))
        stats = t_driver.device_stats_to_hmm_stats(
            model, table, {k: v[0] for k, v in out.items()})
        lls.append(stats.num_ll)
        model = t_estimate.estimate_ml(model, table, stats, minvar=0.01)
    assert lls[1] > lls[0]
    assert lls[2] >= lls[1] - 1e-3 and lls[3] >= lls[2] - 1e-3


# -- accumulators -------------------------------------------------------------

def _dump_bytes(stats, base):
    stats.dump(str(base))
    return {ext: (base.parent / f"{base.name}.{ext}").read_bytes()
            for ext in ("gks", "mcs", "phs", "lls")}


@pytest.mark.parametrize("full", [False, True])
def test_hmm_stats_dumps_byte_identical(tmp_path, full):
    """The same numbers give the same .gks/.mcs/.phs/.lls bytes, and
    loading (combine_stats) accumulates as the reference does."""
    jm, tm = _models(seed=3)
    jt = j_hmm.TransitionTable.from_model(jm)
    tt = t_hmm.TransitionTable.from_model(tm)
    js = JScorer.from_model(jm)
    g = j_hmm.pad_chain(j_hmm.build_chain(jm, jt, ["a", "_"]), 4, fan=4)
    X = np.random.default_rng(0).normal(0, 1, (12, jm.dim)).astype(np.float32)
    d = j_estep.chain_stats(js, jnp.asarray(X), _jg(g), jnp.int32(12),
                            jt.num_slots, full_stats=full)
    mode = j_acc.PDF_ML_STATS | (j_acc.PDF_ML_FULL_STATS if full else 0)
    want = j_driver.device_stats_to_hmm_stats(jm, jt, d, mode)
    got = t_driver.device_stats_to_hmm_stats(
        tm, tt, {k: np.asarray(v) for k, v in d.items()}, mode)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    assert _dump_bytes(got, tmp_path / "t" / "s") == _dump_bytes(
        want, tmp_path / "j" / "s")
    assert _dump_bytes(convert.hmm_stats(want), tmp_path / "t" / "c") == \
        _dump_bytes(want, tmp_path / "j" / "c")
    jl = j_acc.HmmStats.zeros(jm, jt, mode)
    tl = t_acc.HmmStats.zeros(tm, tt, mode)
    for _ in range(2):
        jl.load(str(tmp_path / "j" / "s"), jt)
        tl.load(str(tmp_path / "j" / "s"), tt)
    assert _dump_bytes(tl, tmp_path / "t" / "l") == _dump_bytes(
        jl, tmp_path / "j" / "l")


# -- host M-step copies -------------------------------------------------------

def _random_stats(jm, jt, rng, mode=j_acc.PDF_ML_STATS):
    s = j_acc.HmmStats.zeros(jm, jt, mode)
    G, D = jm.means.shape
    for buf in s.buffers.values():
        buf.gamma[:] = rng.uniform(0.5, 40, G)
        buf.gamma[1] = 0.0
        buf.mean_acc[:] = buf.gamma[:, None] * (jm.means + rng.normal(
            0, 0.3, (G, D)))
        buf.sec_acc[:] = buf.gamma[:, None] * (jm.covars + (
            buf.mean_acc / np.maximum(buf.gamma, 1)[:, None]) ** 2)
        buf.mix_gamma[:] = rng.uniform(0, 10, buf.mix_gamma.shape)
    s.trans_acc[:] = rng.uniform(0, 20, len(s.trans_acc))
    s.num_ll, s.num_frames = -1234.5, 77
    return s


def _model_bytes(model, base):
    t_mio.write_model(str(base), model)
    return [(base.parent / f"{base.name}.{e}").read_bytes()
            for e in ("gk", "mc", "ph")]


def _same_model_files(tmp_path, jmodel, tmodel):
    (tmp_path / "j").mkdir(exist_ok=True)
    j_mio.write_model(str(tmp_path / "j" / "m"), jmodel)
    want = [(tmp_path / "j" / f"m.{e}").read_bytes() for e in ("gk", "mc", "ph")]
    assert _model_bytes(tmodel, tmp_path / "m") == want


@pytest.mark.parametrize("op", [
    "ml", "ml_minweight", "split", "split_target", "delete", "mremove",
    "mmi", "mpe_limit_ebwd"])
def test_host_mstep_copies_byte_identical(tmp_path, op):
    """estimate_ml, split_gaussians, delete_gaussians,
    remove_mixture_components and estimate_mmi on the same HmmStats
    write the same model files."""
    jm, tm = _models(seed=8)
    jt = j_hmm.TransitionTable.from_model(jm)
    tt = t_hmm.TransitionTable.from_model(tm)
    rng = np.random.default_rng(3)
    mode = j_acc.PDF_ML_STATS
    if op == "mmi":
        mode |= j_acc.PDF_MMI_STATS
    if op.startswith("mpe"):
        mode |= j_acc.PDF_MPE_NUM_STATS | j_acc.PDF_MPE_DEN_STATS
    js = _random_stats(jm, jt, rng, mode)
    ts = convert.hmm_stats(js)
    if op.startswith("ml"):
        kw = dict(minvar=0.2, mixture_minweight=0.3 if "min" in op else 0.0)
        out = (j_estimate.estimate_ml(jm, jt, js, **kw),
               t_estimate.estimate_ml(tm, tt, ts, **kw))
    elif op.startswith("split"):
        kw = dict(minocc=2.0, maxg=4, splitalpha=0.5,
                  numgauss=9 if "target" in op else -1)
        (jo, jn), (to, tn) = (j_split.split_gaussians(jm, js, **kw),
                              t_split.split_gaussians(tm, ts, **kw))
        assert jn == tn
        out = (jo, to)
    elif op == "delete":
        (jo, jn), (to, tn) = (j_split.delete_gaussians(jm, js, 10.0),
                              t_split.delete_gaussians(tm, ts, 10.0))
        assert jn == tn > 0
        out = (jo, to)
    elif op == "mremove":
        (jo, jn), (to, tn) = (j_split.remove_mixture_components(jm, 0.45),
                              t_split.remove_mixture_components(tm, 0.45))
        assert jn == tn > 0
        out = (jo, to)
    else:
        fixed = rng.uniform(-1, 5, jm.num_gaussians)
        kw = (dict(mode="mmi", tau=1.0) if op == "mmi" else
              dict(mode="mpe", max_kld=0.05, fixed_d=fixed))
        jd, td = {}, {}
        out = (j_ebw.estimate_mmi(jm, jt, js, d_out=jd, **kw),
               t_ebw.estimate_mmi(tm, tt, ts, d_out=td, **kw))
        for k in jd:
            np.testing.assert_array_equal(td[k], jd[k])
    _same_model_files(tmp_path, *out)


def test_durations_and_clustering_identical():
    rng = np.random.default_rng(0)
    ja, ta = j_dur.DurationAccumulator(6), t_dur.DurationAccumulator(6)
    for _ in range(300):
        s, d = int(rng.integers(0, 6)), int(rng.integers(1, 30))
        ja.add_segment(s, d)
        ta.add_segment(s, d)
    path = rng.integers(0, 6, 50)
    ja.add_path(path)
    ta.add_path(path)
    np.testing.assert_array_equal(ta.estimate(1, 3), ja.estimate(1, 3))
    means = rng.normal(0, 2, (40, 5))
    covs = rng.uniform(0.3, 2, (40, 5))
    np.testing.assert_array_equal(t_gcluster.cluster_gaussians(means, 7),
                                  j_gcluster.cluster_gaussians(means, 7))
    np.testing.assert_array_equal(
        t_gcluster.cluster_gaussians_ref(means, covs, 7),
        j_gcluster.cluster_gaussians_ref(means, covs, 7))


def test_mllt_matches_reference():
    """full_second_moment_stats against the reference's device pass;
    solve_mllt/apply_mllt/compose_into_config host copies identical."""
    jm, tm = _models(seed=2)
    jt = j_hmm.TransitionTable.from_model(jm)
    js = JScorer.from_model(jm)
    g = j_hmm.pad_chain(j_hmm.build_chain(jm, jt, ["a", "_"]), 3)
    X = np.random.default_rng(0).normal(0, 2, (16, jm.dim)).astype(np.float32)
    want = j_mllt.full_second_moment_stats(js, jnp.asarray(X), _jg(g),
                                           jnp.int32(16), jm.num_gaussians)
    got = t_mllt.full_second_moment_stats(
        convert.gmm_scorer(js), torch.as_tensor(X)[None], _tg(g), _n(16),
        jm.num_gaussians)
    for k, rtol in (("gamma", 1e-5), ("m1", 1e-4), ("m2_full", 1e-4)):
        _close_scaled(np.asarray(want[k]), _np(got[k][0]), rtol, k)
    assert float(got["ll"][0]) == pytest.approx(float(want["ll"]), rel=1e-5)
    G = jm.num_gaussians
    gam, m1, m2 = (np.asarray(want[k], np.float64)[:G]
                   for k in ("gamma", "m1", "m2_full"))
    A = t_mllt.solve_mllt(gam, m1, m2, iters=3)
    np.testing.assert_array_equal(A, j_mllt.solve_mllt(gam, m1, m2, iters=3))
    jo, to = j_mllt.apply_mllt(jm, A), t_mllt.apply_mllt(tm, A)
    np.testing.assert_array_equal(to.means, jo.means)
    np.testing.assert_array_equal(to.covars, jo.covars)
    from aaltoasr_tpu.formats.feaconf import FeatureConfig as JCfg
    from aaltoasr_tpu_torch.formats.feaconf import FeatureConfig as TCfg
    from tests.test_train_cli import CFG
    jc, tc = JCfg.parse(CFG), TCfg.parse(CFG)
    j_mllt.compose_into_config(jc, A)
    t_mllt.compose_into_config(tc, A)
    assert tc.dump() == jc.dump()


# -- EStepDriver ----------------------------------------------------------------

def write_corpus(tmp_path, rng, seqs=("_ a _", "a _", "_ a a _")):
    """WAVs with transcripts and alignment= targets; 4-dim features
    (`tests/test_train_cli.py` CFG).  Returns the recipe path."""
    from tests.test_train_cli import CFG
    (tmp_path / "feats.cfg").write_text(CFG)
    lines = []
    for u, seq in enumerate(seqs):
        n = 4000 + 300 * u
        sig = (2000 * np.sin(2 * np.pi * (300 + 120 * u) * np.arange(n)
                             / 16000)
               + 200 * rng.standard_normal(n)).astype("<i2")
        wav = tmp_path / f"u{u}.wav"
        with wave.open(str(wav), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(sig.tobytes())
        (tmp_path / f"u{u}.phn").write_text("\n".join(seq.split()) + "\n")
        lines.append(f"audio={wav} transcript={tmp_path}/u{u}.phn "
                     f"alignment={tmp_path}/u{u}.ali.phn")
    (tmp_path / "recipe").write_text("\n".join(lines) + "\n")
    return tmp_path / "recipe"


def _stats_dumps_close(t, j, golden=True):
    """HmmStats of the two packages: within the golden-stats tolerances
    where both saw the same state sequence (``golden``: fixed
    alignments, host float64), else within the tolerances the JAX
    package holds its own batched E-step to against its sequential one
    (`tests/test_train.py:360-369`): each package computes its features
    and float32 log-likelihoods in its own order, and posteriors move
    with them.  Feature counts and frame counts identical."""
    tb, jb = t.buffers[t_acc.ML_BUF], j.buffers[j_acc.ML_BUF]
    if golden:
        for name, rtol in STATS_TOL:
            _close_scaled(getattr(jb, name), getattr(tb, name), rtol, name)
        _close_scaled(j.trans_acc, t.trans_acc, 1e-6, "trans_acc")
        assert t.num_ll == pytest.approx(j.num_ll, rel=1e-5)
    else:
        np.testing.assert_allclose(tb.gamma, jb.gamma, rtol=2e-3, atol=1e-3)
        np.testing.assert_allclose(tb.mix_gamma, jb.mix_gamma, rtol=2e-3,
                                   atol=1e-3)
        np.testing.assert_allclose(tb.mean_acc, jb.mean_acc, rtol=5e-3,
                                   atol=0.05)
        np.testing.assert_allclose(tb.sec_acc, jb.sec_acc, rtol=5e-3,
                                   atol=0.05)
        np.testing.assert_allclose(t.trans_acc, j.trans_acc, rtol=2e-3,
                                   atol=2e-3)
        assert t.num_ll == pytest.approx(j.num_ll, rel=1e-4)
    if jb.full_acc is not None:
        np.testing.assert_allclose(tb.full_acc, jb.full_acc, rtol=5e-3,
                                   atol=0.05)
    np.testing.assert_array_equal(tb.feacount, jb.feacount)
    assert t.num_frames == j.num_frames


@pytest.mark.parametrize("how", ["batched", "bw", "vit", "full", "aligned"])
def test_driver_matches_reference(tmp_path, how):
    from aaltoasr_tpu.formats.recipe import Recipe as JRecipe
    from aaltoasr_tpu_torch.formats.recipe import Recipe as TRecipe
    recipe = write_corpus(tmp_path, np.random.default_rng(4))
    jm, tm = _models(seed=5)
    cfg = str(tmp_path / "feats.cfg")
    kw = dict(mode="vit" if how == "vit" else "bw",
              full_stats=how == "full")
    jd = j_driver.EStepDriver(jm, cfg, **kw)
    td = t_driver.EStepDriver(tm, cfg, device="cpu", **kw)
    if how == "aligned":
        from aaltoasr_tpu.cli.align import main as j_align
        assert j_align(["-b", _write(tmp_path, jm), "-c", cfg,
                        "-r", str(recipe)]) == 0
        run = "run_recipe_aligned"
    else:
        run = "run_recipe_batched" if how == "batched" else "run_recipe"
    extra = {"batch_size": 2} if how == "batched" else {}
    want = getattr(jd, run)(JRecipe.read(str(recipe)), **extra)
    got = getattr(td, run)(TRecipe.read(str(recipe)), **extra)
    _stats_dumps_close(got, want, golden=how == "aligned")
    if how == "batched":
        one = t_driver.EStepDriver(tm, cfg, device="cpu").run_recipe(
            TRecipe.read(str(recipe)))
        _stats_dumps_close(got, one, golden=False)


def _write(tmp_path, jm):
    j_mio.write_model(str(tmp_path / "am"), jm)
    return str(tmp_path / "am")


def test_driver_hmmnet_options_raise(tmp_path, monkeypatch):
    """The hmmnet options of `EStepDriver` (once refused, now ported):
    -H, --mmi and --mpe on a recipe with hmmnet= and den-hmmnet=
    networks, and mode mpv, against the reference's driver on the same
    features (every buffer within `tests/test_torch_discrim.py`'s
    per-utterance tolerances)."""
    from aaltoasr_tpu.formats.recipe import Recipe as JRecipe
    from aaltoasr_tpu_torch.formats.recipe import Recipe as TRecipe
    from tests.test_torch_discrim import hmmnet_corpus, stats_close_all
    from tests.test_torch_train_cli import use_reference_features
    use_reference_features(monkeypatch)
    lines = hmmnet_corpus(tmp_path, n_utts=1).splitlines()
    jm = j_mio.read_model(str(tmp_path / "am"))
    cfg = str(tmp_path / "feats.cfg")
    for mode, kw in (("bw", dict(use_hmmnet=True, mmi=True, mpe=True,
                                 errmode="mpfe-pdf")),
                     ("mpv", dict(use_hmmnet=True))):
        want = j_driver.EStepDriver(jm, cfg, mode=mode).run_recipe(
            JRecipe.read(lines), **kw)
        got = t_driver.EStepDriver(convert.hmm_model(jm), cfg, mode=mode,
                                   device="cpu").run_recipe(
            TRecipe.read(lines), **kw)
        stats_close_all(got, want)
