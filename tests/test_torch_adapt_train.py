"""PyTorch port, speaker adaptation estimation: `warp_grid`,
`VtlnEstimator` (transcript and aligned modes), `cmllr_stats`,
`cmllr_stats_aligned`, `solve_cmllr`, `CmllrEstimator` (its identity
gate included), regression trees and LDA, each against the JAX package
on the same seeded inputs (CPU).

Tolerances: warp curves rel 1e-5 and the chosen warps identical (where
the two best grid points lie within that tolerance of each other the
test says so and accepts either); fixed-segmentation CMLLR statistics
within 1e-5 of their scale; transcript CMLLR statistics within 1e-5 of
scale on the same responsibilities, and within 1e-3 of scale end to end,
where each package's float32 log-domain forward-backward rounds its
posteriors differently (exp(alpha + beta - total) with |alpha| ~ 1e3
carries errors of ~1e-4); transforms within atol 1e-3; host code
(solve, trees, LDA) identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aaltoasr_tpu.formats.feaconf import FeatureConfig as JConfig
from aaltoasr_tpu.formats.feaconf import ModuleConfig as JModuleConfig
from aaltoasr_tpu.frontend.generator import FeatureGenerator as JGen
from aaltoasr_tpu.models.hmm import TransitionTable as JTable
from aaltoasr_tpu.models.hmm import build_chain as j_build_chain
from aaltoasr_tpu.models.hmm import pad_chain as j_pad_chain
from aaltoasr_tpu.ops.gmm import GmmScorer as JScorer
from aaltoasr_tpu.train import estep as j_estep
from aaltoasr_tpu.train import lda as j_lda
from aaltoasr_tpu.train import mllr as j_mllr
from aaltoasr_tpu.train import regtree as j_regtree
from aaltoasr_tpu.train import vtln as j_vtln

from aaltoasr_tpu_torch.formats.feaconf import FeatureConfig
from aaltoasr_tpu_torch.frontend.generator import FeatureGenerator
from aaltoasr_tpu_torch.models.hmm import (
    TransitionTable, build_chain, pad_chain)
from aaltoasr_tpu_torch.ops.gmm import GmmScorer
from aaltoasr_tpu_torch.train import estep
from aaltoasr_tpu_torch.train import lda as t_lda
from aaltoasr_tpu_torch.train import mllr as t_mllr
from aaltoasr_tpu_torch.train import regtree as t_regtree
from aaltoasr_tpu_torch.train import vtln as t_vtln

from tests.test_adaptation import VTLN_CFG as VTLN_SRC_CFG
from tests.test_golden_adaptation import VTLN_CFG, speaker_wave
from tests.test_train import three_state_model

torch.set_num_threads(1)

CPU = torch.device("cpu")
LABELS = ["_", "a", "_"]


@pytest.mark.parametrize("center,radius,size", [
    (1.0, 0.1, 21), (1.0, 0.1, 11), (0.94, 0.05, 7), (1.0, 0.1, 1)])
def test_warp_grid(center, radius, size):
    np.testing.assert_array_equal(
        t_vtln.warp_grid(center, radius, size),
        j_vtln.warp_grid(center, radius, size))


def _vtln_pair(size=21, cfg=VTLN_CFG, model=None):
    model = model or three_state_model(seed=0, D=4)
    j = j_vtln.VtlnEstimator(model, JTable.from_model(model),
                             JScorer.from_model(model),
                             JGen(JConfig.parse(cfg)), "vtln", size=size)
    t = t_vtln.VtlnEstimator(model, TransitionTable.from_model(model),
                             GmmScorer.from_model(model, device=CPU),
                             FeatureGenerator(FeatureConfig.parse(cfg),
                                              device=CPU), "vtln", size=size)
    return model, j, t


def _speaker_audio(kind, n_utts=2, seed=11):
    rng = np.random.default_rng(seed)
    return [speaker_wave(rng, kind, 6000 + 400 * u).astype(np.float32)
            for u in range(n_utts)]


def _same_warp(jw, tw, curve, warps):
    """The chosen warps are identical unless the curve's two best points
    lie within its tolerance (then either is accepted, and said)."""
    order = np.argsort(-curve)
    gap = curve[order[0]] - curve[order[1]]
    if gap <= 1e-5 * abs(curve[order[0]]):
        print(f"near tie: {warps[order[0]]} and {warps[order[1]]} differ "
              f"by {gap:.3g}; accepting either")
        assert tw in (warps[order[0]], warps[order[1]])
    else:
        assert tw == jw


@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("kind", ["a", "b"])
def test_vtln_estimator_curves_and_warps(kind, aligned):
    model, j, t = _vtln_pair()
    utts = []
    for samples in _speaker_audio(kind):
        if aligned:
            T = (len(samples) - 400) // 128
            states = np.repeat([2, 0, 1, 2], T // 4 + 1)[:T].astype(np.int32)
            utts.append((samples, states))
        else:
            utts.append((samples, LABELS))
    jw, jc, warps = j.estimate_speaker(utts, aligned=aligned)
    before = {k: v.clone() for k, v in t.fg._dev_params["vtln"].items()}
    tw, tc, tgrid = t.estimate_speaker(utts, aligned=aligned)
    np.testing.assert_array_equal(tgrid, warps)
    np.testing.assert_allclose(tc, jc, rtol=1e-5)
    _same_warp(jw, tw, jc, warps)
    # the grid never touches the generator's own parameters
    for k, v in t.fg._dev_params["vtln"].items():
        assert torch.equal(v, before[k])


def test_vtln_recovers_true_warp():
    """`tests/test_adaptation.py::TestVtln`: features generated with warp
    w*; both packages' grid searches pick the same point near w*."""
    text = VTLN_SRC_CFG.replace(
        "sources fft\n}\nmodule\n{\n  name mel\n  type mel\n  sources fft",
        "sources fft\n}\nmodule\n{\n  name mel\n  type mel\n  sources vtln")
    rng = np.random.default_rng(0)
    n = 4000
    tt = np.arange(n)
    audio = np.round(
        4000 * np.sin(2 * np.pi * 800 * tt / 16000)
        + 2000 * np.sin(2 * np.pi * 2500 * tt / 16000)
        + 100 * rng.standard_normal(n)).astype(np.float32)
    gen = JGen(JConfig.parse(text))
    pc = JModuleConfig()
    pc.set("warp_factor", 1.06)
    gen.set_parameters("vtln", pc)
    feats = np.asarray(gen.features(audio))
    from aaltoasr_tpu.formats import model_io
    model = model_io.HmmModel(
        dim=4, cov_type="diagonal_cov", means=feats.mean(0)[None, :],
        covars=np.maximum(feats.var(0), 0.05)[None, :],
        mixtures=[(np.array([0], np.int32), np.array([1.0]))],
        phones=[model_io.HmmPhone("a", [0])],
        transitions={0: [(0, 0.9), (1, 0.1)]})
    _, j, t = _vtln_pair(size=11, cfg=text, model=model)
    jw, jc, warps = j.estimate_speaker([(audio, ["a"])])
    tw, tc, _ = t.estimate_speaker([(audio, ["a"])])
    np.testing.assert_allclose(tc, jc, rtol=1e-5)
    _same_warp(jw, tw, jc, warps)
    assert abs(tw - 1.06) <= 0.021


def test_forward_log_likelihood_is_the_fb_total():
    model = three_state_model(seed=3)
    table = TransitionTable.from_model(model)
    chains = [build_chain(model, table, lab) for lab in (LABELS, ["a"])]
    graph = estep.stack_graphs([pad_chain(c, 8) for c in chains], CPU)
    obs = torch.as_tensor(np.random.default_rng(1).normal(
        -5, 2, (2, 30, 8)).astype(np.float32))
    n = torch.tensor([30, 21])
    want = estep.masked_forward_backward(obs, graph, n, table.num_slots,
                                         with_transitions=False)[2]
    assert torch.equal(estep.masked_forward_log_likelihood(obs, graph, n),
                       want)


# ---------------------------------------------------------------------------
# CMLLR

def _model_data(T, seed=4, shift=1.5):
    """`tests/test_adaptation.py`'s data: frames drawn from the model's
    states, shifted."""
    model = three_state_model(seed=3)
    rng = np.random.default_rng(seed)
    states = np.repeat([2, 0, 1, 2], T // 4 + 1)[:T]
    X = np.zeros((T, model.dim), dtype=np.float32)
    for t, s in enumerate(states):
        idx, w = model.mixtures[s]
        g = idx[rng.choice(len(idx), p=w)]
        X[t] = rng.normal(model.means[g], np.sqrt(model.covars[g]))
    return model, (X + shift).astype(np.float32), states


def _estimators(model, C):
    js = JScorer.from_model(model)
    ts = GmmScorer.from_model(model, device=CPU)
    Gp = js.score_matrix.shape[1]
    assert ts.score_matrix.shape[1] == Gp
    classes = (np.arange(Gp) % C).astype(np.int32)
    j = j_mllr.CmllrEstimator(js, JTable.from_model(model), classes, C,
                              model.means, model.covars)
    t = t_mllr.CmllrEstimator(ts, TransitionTable.from_model(model),
                              classes, C, model.means, model.covars)
    return j, t


def _graphs(model):
    jc = j_build_chain(model, JTable.from_model(model), LABELS)
    tc = build_chain(model, TransitionTable.from_model(model), LABELS)
    return ({k: jnp.asarray(v)
             for k, v in j_pad_chain(jc, jc.num_positions).items()},
            pad_chain(tc, tc.num_positions))


def _close_to_scale(got, want, rel):
    for k in ("beta", "k", "G"):
        a = np.asarray(want[k], np.float64)
        dev = np.abs(np.asarray(got[k], np.float64) - a).max()
        assert dev <= rel * np.abs(a).max(), (k, dev / np.abs(a).max())


@pytest.fixture
def fixed_gamma(monkeypatch):
    """Both packages' forward-backward return the same seeded state
    posteriors (live positions, each frame summing to 1), so the
    statistics are compared on the same responsibilities."""
    cache = {}

    def gamma(T, P):
        if (T, P) not in cache:
            g = np.random.default_rng(T * 31 + P).uniform(0.05, 1, (T, P))
            cache[(T, P)] = (g / g.sum(1, keepdims=True)).astype(np.float32)
        return cache[(T, P)]

    def j_fb(obs_pos, graph, n_frames, num_trans_slots, **_):
        T, P = obs_pos.shape
        return (jnp.asarray(gamma(T, P)), jnp.zeros(num_trans_slots),
                jnp.float32(0.0))

    def t_fb(obs_pos, graph, n_frames, num_trans_slots, **_):
        B, T, P = obs_pos.shape
        return (torch.as_tensor(gamma(T, P))[None],
                torch.zeros((B, num_trans_slots)), torch.zeros(B))

    monkeypatch.setattr(j_estep, "masked_forward_backward", j_fb)
    monkeypatch.setattr(estep, "masked_forward_backward", t_fb)


@pytest.mark.parametrize("C", [1, 2])
def test_cmllr_stats_same_responsibilities(fixed_gamma, C):
    model, X, _ = _model_data(200)
    j, t = _estimators(model, C)
    jg, tg = _graphs(model)
    j.accumulate(X, jg, X.shape[0])
    t.accumulate(X, tg, X.shape[0])
    _close_to_scale(t._acc, j._acc, 1e-5)


@pytest.mark.parametrize("T", [200, 1000])
@pytest.mark.parametrize("C", [1, 2])
def test_cmllr_stats_end_to_end(C, T):
    model, X, _ = _model_data(T)
    j, t = _estimators(model, C)
    jg, tg = _graphs(model)
    j.accumulate(X, jg, T)
    t.accumulate(X, tg, T)
    _close_to_scale(t._acc, j._acc, 1e-3)
    assert float(t._acc["ll"]) == pytest.approx(float(j._acc["ll"]),
                                                rel=1e-5)
    for Wt, Wj in zip(t.transforms(min_frames=10),
                      j.transforms(min_frames=10)):
        np.testing.assert_allclose(Wt, Wj, atol=1e-3)


@pytest.mark.parametrize("C", [1, 2, 3])
def test_cmllr_stats_aligned(C):
    model, X, states = _model_data(300, seed=6)
    j, t = _estimators(model, C)
    j.accumulate_aligned(X, states)
    t.accumulate_aligned(X, states)
    _close_to_scale(t._acc, j._acc, 1e-5)
    assert float(t._acc["ll"]) == pytest.approx(float(j._acc["ll"]),
                                                rel=1e-5)
    for Wt, Wj in zip(t.transforms(min_frames=10),
                      j.transforms(min_frames=10)):
        np.testing.assert_allclose(Wt, Wj, atol=1e-3)


def test_cmllr_estimator_improves_likelihood():
    """`tests/test_adaptation.py::TestCmllr::test_estimator_improves_
    likelihood` through the port."""
    model, X, _ = _model_data(200)
    _, t = _estimators(model, 1)
    _, tg = _graphs(model)
    t.accumulate(X, tg, 200)
    W = t.transforms(min_frames=10)[0]
    _, t2 = _estimators(model, 1)
    t2.accumulate((X @ W[:, 1:].T + W[:, 0]).astype(np.float32), tg, 200)
    assert float(t2._acc["ll"]) > float(t._acc["ll"]) + 10


@pytest.mark.parametrize("D,shift,seed", [(3, 0.0, 1), (2, 2.0, 2),
                                          (4, -1.0, 3)])
def test_solve_cmllr_identical(D, shift, seed):
    """`tests/test_adaptation.py`'s solve cases: the host copy gives the
    reference's float64 transform exactly."""
    rng = np.random.default_rng(seed)
    T = 8000
    mu = rng.normal(0, 3, (T, D))
    X = mu + shift + rng.normal(0, 1, (T, D))
    xi = np.concatenate([np.ones((T, 1)), X], axis=1)
    G = np.stack([xi.T @ xi for _ in range(D)])
    k = np.stack([xi.T @ mu[:, i] for i in range(D)])
    W = t_mllr.solve_cmllr(G, k, float(T))
    np.testing.assert_array_equal(W, j_mllr.solve_cmllr(G, k, float(T)))
    np.testing.assert_allclose(W[:, 1:], np.eye(D), atol=0.1)
    np.testing.assert_allclose(W[:, 0], -shift, atol=0.2)


@pytest.mark.parametrize("offset", [-1.0, 1.0])
def test_cmllr_min_frames_gate(offset):
    """Identity where a class's beta is below min_frames, a solved
    transform at or above it, in both packages; the gate sits `offset`
    frames from the beta of class 0 (the margin is printed)."""
    model, X, states = _model_data(300, seed=6)
    j, t = _estimators(model, 2)
    j.accumulate_aligned(X, states)
    t.accumulate_aligned(X, states)
    beta = float(t._acc["beta"][0])
    gate = beta + offset
    print(f"class 0 beta {beta:.6f} (reference {j._acc['beta'][0]:.6f}), "
          f"gate {gate:.6f}")
    Wt, Wj = t.transforms(gate), j.transforms(gate)
    for a, b in zip(Wt, Wj):
        np.testing.assert_allclose(a, b, atol=1e-3)
    ident = np.concatenate([np.zeros((model.dim, 1)), np.eye(model.dim)], 1)
    assert np.array_equal(Wt[0], ident) == (offset > 0)


# ---------------------------------------------------------------------------
# regression trees and LDA

@pytest.mark.parametrize("G,D,terminals,min_gauss,seed", [
    (40, 3, 2, 4, 5), (32, 4, 4, 2, 6), (300, 39, 8, 8, 7),
    (64, 5, 16, 2, 8)])
def test_regression_tree_identical(tmp_path, G, D, terminals, min_gauss,
                                   seed):
    rng = np.random.default_rng(seed)
    means = rng.normal(0, 3, (G, D))
    occ = rng.uniform(1, 100, G)
    for occupancies in (None, occ):
        tj = j_regtree.build_regression_tree(
            means, occupancies, num_terminals=terminals,
            min_gaussians=min_gauss)
        tt = t_regtree.build_regression_tree(
            means, occupancies, num_terminals=terminals,
            min_gaussians=min_gauss)
        cls = t_regtree.terminal_classes(tt, G)
        np.testing.assert_array_equal(cls, j_regtree.terminal_classes(tj, G))
        j_regtree.write_regtree(tj, str(tmp_path / "j.tree"))
        t_regtree.write_regtree(tt, str(tmp_path / "t.tree"))
        assert ((tmp_path / "t.tree").read_bytes()
                == (tmp_path / "j.tree").read_bytes())
        np.testing.assert_array_equal(
            t_regtree.read_regtree(str(tmp_path / "j.tree"), G),
            j_regtree.read_regtree(str(tmp_path / "j.tree"), G))


@pytest.mark.parametrize("classes,dim,out_dim,kw", [
    (2, 4, 1, {}), (6, 5, 3, {"min_gamma": 20.0}),
    (8, 6, 4, {"max_classes": 5, "exclude": (1,), "max_gamma": 150.0})])
def test_lda_identical(classes, dim, out_dim, kw):
    rng = np.random.default_rng(classes)
    accs = [j_lda.LdaAccumulator(classes, dim),
            t_lda.LdaAccumulator(classes, dim)]
    for c in range(classes):
        x = rng.normal(0, 1, (40 + 30 * c, dim)) + rng.normal(0, 3, dim)
        for acc in accs:
            acc.add(c, x)
    np.testing.assert_array_equal(accs[1].solve(out_dim, **kw),
                                  accs[0].solve(out_dim, **kw))
