"""PyTorch port, the rest of GMM scoring: full-covariance, `variable`,
subspace (PCGMM/SCGMM) and cluster-gated scorers, subspace `.gk` files,
`.gcl` files and model-space CMLLR, against the JAX package on the same
numpy inputs (CPU).

Tolerance: the exponential form scores phi(x) = [vec(x x^T), x] against
precision-weighted tables, where terms of size |x|^2 |P| cancel down to
the log-likelihood, so XLA's and torch's float32 sums in other orders
differ in proportion to the largest score: atol 2e-6 * max|ll| (and at
least 1e-4).  Diagonal scorers keep the parity tests' atol 1e-4 at
small D.  Tables built on the host by the copied code must be
identical.
"""

import numpy as np
import pytest
import torch

from aaltoasr_tpu.cli.gconvert import main as j_gconvert
from aaltoasr_tpu.formats import model_io as J_io
from aaltoasr_tpu.ops.gmm import GmmScorer as JGmm
from aaltoasr_tpu.ops.subspaces import PrecisionSubspace as JPrecSub
from aaltoasr_tpu.train.gcluster import cluster_gaussians
from aaltoasr_tpu.train.gcluster import read_gcl as j_read_gcl
from aaltoasr_tpu.train.gcluster import write_gcl as j_write_gcl
from aaltoasr_tpu.train.mllr import apply_model_cmllr as j_model_cmllr

from aaltoasr_tpu_torch import convert
from aaltoasr_tpu_torch.formats import model_io as T_io
from aaltoasr_tpu_torch.ops import subspaces as T_sub
from aaltoasr_tpu_torch.ops.gmm import GmmScorer as TGmm
from aaltoasr_tpu_torch.ops.gmm_cuda import FusedGmmScorer as TFused
from aaltoasr_tpu_torch.train.gcluster import read_gcl as t_read_gcl
from aaltoasr_tpu_torch.train.gcluster import write_gcl as t_write_gcl
from aaltoasr_tpu_torch.train.mllr import apply_model_cmllr as t_model_cmllr

from tests.test_gmm import random_model

# the tests run tiny tensors in several worker processes at once: one
# intra-op thread each avoids oversubscribing the cores
torch.set_num_threads(1)


def _feats(T, D, seed, scale=1.5):
    return np.random.default_rng(seed).normal(0, scale, (T, D)).astype(
        np.float32)


def _close_ll(got, want):
    """atol 2e-6 * max|ll|, at least 1e-4 (module docstring)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(
        got, want, rtol=0, atol=max(1e-4, 2e-6 * float(np.abs(want).max())))


def _both(jmodel, **kw):
    """The reference scorer and the port's, built from the same model."""
    return (JGmm.from_model(jmodel),
            TGmm.from_model(convert.hmm_model(jmodel), device="cpu", **kw))


def _check_scorers(j, t, x, tables=True):
    """Tables identical (the same numpy code built them), then the
    Gaussian and state log-likelihoods within tolerance."""
    assert t.full_cov == j.full_cov
    if tables:
        for name in ("score_matrix", "score_bias", "comp_idx", "comp_logw"):
            np.testing.assert_array_equal(getattr(t, name).numpy(),
                                          np.asarray(getattr(j, name)))
        assert len(t.sub_basis) == len(j.sub_basis)
        for tb, jb in zip(t.sub_basis + t.sub_lambda,
                          j.sub_basis + j.sub_lambda):
            np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    G, S = j.num_gaussians, j.num_states
    _close_ll(t.gaussian_log_likelihoods(torch.tensor(x))[:, :G],
              np.asarray(j.gaussian_log_likelihoods(x))[:, :G])
    _close_ll(t.state_log_likelihoods(torch.tensor(x))[:, :S],
              np.asarray(j.state_log_likelihoods(x))[:, :S])
    # and through the converter: the reference's tables, carried
    c = convert.gmm_scorer(j)
    _close_ll(c.state_log_likelihoods(torch.tensor(x))[:, :S],
              np.asarray(j.state_log_likelihoods(x))[:, :S])


def _full_model(seed=0, D=5, G=12, S=4, spd=True):
    """A `variable` pool: even Gaussians full-covariance, odd diagonal;
    with spd=False Gaussian 0's covariance is not positive definite."""
    model = random_model(G=G, S=S, D=D, K=3, seed=seed)
    rng = np.random.default_rng(seed + 100)
    model.cov_type = "variable"
    model.gauss_kind = []
    model.full_covars = {}
    for g in range(G):
        if g % 2 == 0:
            L = rng.normal(0, 0.4, (D, D))
            model.full_covars[g] = L @ L.T + np.eye(D)
            model.covars[g] = np.diag(model.full_covars[g])
            model.gauss_kind.append("full")
        else:
            model.gauss_kind.append("diag")
    if not spd:
        model.full_covars[0] = -np.eye(D)
    return model


@pytest.mark.parametrize("spd", [True, False])
@pytest.mark.parametrize("D", [5, 13])
def test_full_covariance(D, spd):
    """Full and diagonal Gaussians in one pool; a covariance that is not
    SPD scores the constant 0 on both sides (the reference's invalid
    parameters branch)."""
    j, t = _both(_full_model(seed=D, D=D, G=3 * D, S=D, spd=spd))
    x = _feats(40, D, seed=1)
    _check_scorers(j, t, x)
    if not spd:
        gll = t.gaussian_log_likelihoods(torch.tensor(x))
        np.testing.assert_allclose(gll[:, 0].numpy(), 0.0, atol=1e-5)


def test_full_covariance_loud_features():
    """MFCC-like magnitudes (|x| to ~40): phi(x) squares them, the
    cancellation the tolerance is relative to."""
    model = _full_model(seed=3, D=13, G=40, S=12)
    model.means *= 10.0
    j, t = _both(model)
    _check_scorers(j, t, _feats(60, 13, seed=2, scale=15.0))


def _pool_with_pcgmm(rng, D=4, G=6):
    """As tests/test_subspaces.py::TestMixedVariablePool: diag, full and
    pcgmm rows in one `variable` pool, over a full-dimensional subspace."""
    model = random_model(G=G, S=3, D=D, K=2, seed=21)
    L = rng.normal(0, 0.2, (D, D))
    C1 = L @ L.T + np.diag(model.covars[1])
    dvec = D * (D + 1) // 2
    ps = JPrecSub.initialize_pca(
        np.ones(G), [np.diag(model.covars[g]) for g in range(G)],
        basis_dim=dvec + 1)
    lam = ps.optimize_coefficients(np.diag(model.covars[2]))
    P2 = ps.compute_precision(lam)
    model.cov_type = "variable"
    model.gauss_kind = ["diag", "full", "pcgmm"] + ["diag"] * (G - 3)
    model.full_covars = {1: C1}
    model.precision_subspaces = {1: ps}
    model.pcgmm_params = {2: (1, P2 @ model.means[2], lam)}
    return model


def _same_subspace_model(t, j):
    assert t.gauss_kind == j.gauss_kind and t.cov_type == j.cov_type
    np.testing.assert_array_equal(t.means, j.means)
    np.testing.assert_array_equal(t.covars, j.covars)
    assert t.full_covars.keys() == j.full_covars.keys()
    for g in j.full_covars:
        np.testing.assert_array_equal(t.full_covars[g], j.full_covars[g])
    for ssid, ps in j.precision_subspaces.items():
        np.testing.assert_array_equal(t.precision_subspaces[ssid].basis,
                                      ps.basis)
    for ssid, es in j.exponential_subspaces.items():
        np.testing.assert_array_equal(
            t.exponential_subspaces[ssid].basis_theta, es.basis_theta)
    for attr in ("pcgmm_params", "scgmm_params"):
        tp, jp = getattr(t, attr), getattr(j, attr)
        assert tp.keys() == jp.keys()
        for g in jp:
            assert tp[g][0] == jp[g][0]
            for a, b in zip(tp[g][1:], jp[g][1:]):
                np.testing.assert_array_equal(a, b)


def test_variable_pool_diag_full_pcgmm(tmp_path):
    """A `variable` .gk mixing diag, full and pcgmm rows, written by the
    JAX writer: the port's `read_gk` reads what the reference reads, and
    the scorers agree."""
    model = _pool_with_pcgmm(np.random.default_rng(21))
    J_io.write_model(str(tmp_path / "mix"), model)
    jm = J_io.read_model(str(tmp_path / "mix"))
    tm = T_io.read_model(str(tmp_path / "mix"))
    _same_subspace_model(tm, jm)
    assert isinstance(tm.precision_subspaces[1], T_sub.PrecisionSubspace)
    j, t = JGmm.from_model(jm), TGmm.from_model(tm, device="cpu")
    assert len(t.sub_basis) == 1
    _check_scorers(j, t, _feats(8, 4, seed=3))
    # and the port's writer is read back by the reference
    T_io.write_model(str(tmp_path / "again"), tm)
    _same_subspace_model(tm, J_io.read_model(str(tmp_path / "again")))


@pytest.mark.parametrize("flag,kind", [("--to-pcgmm", "pcgmm"),
                                       ("--to-scgmm", "scgmm")])
def test_subspace_model_from_gconvert(tmp_path, flag, kind):
    """A diagonal model converted by the JAX gconvert to pcgmm or scgmm
    Gaussians over full-dimensional subspaces; the port reads the .gk
    and scores it as the reference does."""
    from tests.test_subspaces import _toy_model
    J_io.write_model(str(tmp_path / "in"),
                     _toy_model(np.random.default_rng(7)))
    dvec = 4 * 5 // 2
    ssdim = dvec if kind == "pcgmm" else 4 + dvec
    assert j_gconvert(["-b", str(tmp_path / "in"), "-o",
                       str(tmp_path / "out"), flag,
                       "--ssdim", str(ssdim)]) == 0
    jm = J_io.read_model(str(tmp_path / "out"))
    tm = T_io.read_model(str(tmp_path / "out"))
    _same_subspace_model(tm, jm)
    assert tm.gauss_kind == [kind] * 6
    j, t = JGmm.from_model(jm), TGmm.from_model(tm, device="cpu")
    assert len(t.sub_basis) == 1
    _check_scorers(j, t, _feats(10, 4, seed=4))


def _gated(model, C, eval_minc, eval_ming, assign=None):
    if assign is None:
        assign = cluster_gaussians(model.means, C)
    j = JGmm.from_model(model).with_clustering(
        model, assign, C, eval_minc=eval_minc, eval_ming=eval_ming)
    tmodel = convert.hmm_model(model)
    t = TGmm.from_model(tmodel, device="cpu").with_clustering(
        tmodel, assign, C, eval_minc=eval_minc, eval_ming=eval_ming)
    for name in ("cluster_of", "cluster_matrix", "cluster_bias",
                 "cluster_sizes"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)))
    assert (t.min_eval_clusters, t.min_eval_gauss) == (
        j.min_eval_clusters, j.min_eval_gauss)
    return j, t


@pytest.mark.parametrize("eval_minc,eval_ming", [(0.0, 0.1), (0.0, 0.25),
                                                 (0.5, 0.0), (0.0, 1.0)])
def test_gated_scoring(eval_minc, eval_ming):
    """As tests/test_gmm.py::TestClusterGating; with eval_ming 1.0 every
    cluster is selected and the gated scores equal the dense ones."""
    model = random_model(G=40, S=12, D=6, K=3, seed=7)
    j, t = _gated(model, 6, eval_minc, eval_ming)
    x = _feats(30, 6, seed=8, scale=1.0)
    _close_ll(t.gated_gaussian_log_likelihoods(torch.tensor(x)),
              np.asarray(j.gated_gaussian_log_likelihoods(x)))
    _check_scorers(j, t, x)
    if eval_ming == 1.0:
        dense = TGmm.from_model(convert.hmm_model(model), device="cpu")
        torch.testing.assert_close(
            t.state_log_likelihoods(torch.tensor(x)),
            dense.state_log_likelihoods(torch.tensor(x)), rtol=0, atol=1e-5)


def test_gated_ties_keep_the_lower_cluster_first():
    """Two clusters with identical members score identical centers on
    every frame; the stable rank puts the lower index first, as
    `jnp.argsort` does, so the same Gaussians are scored exactly."""
    base = random_model(G=8, S=6, D=5, K=2, seed=11)
    model = random_model(G=16, S=6, D=5, K=3, seed=11)
    model.means = np.concatenate([base.means, base.means])
    model.covars = np.concatenate([base.covars, base.covars])
    assign = np.repeat(np.arange(4, dtype=np.int32), 4)
    # clusters 0 and 2 hold the same four Gaussians, 1 and 3 too
    assign = np.concatenate([assign[:8], assign[:8] + 2])
    j, t = _gated(model, 4, 0.0, 0.3, assign=assign)
    x = _feats(25, 5, seed=12, scale=1.0)
    cll = (torch.cat([torch.tensor(x) ** 2, torch.tensor(x)], 1)
           @ t.cluster_matrix + t.cluster_bias)
    torch.testing.assert_close(cll[:, 0], cll[:, 2], rtol=0, atol=0)
    got = t.gated_gaussian_log_likelihoods(torch.tensor(x)).numpy()
    want = np.asarray(j.gated_gaussian_log_likelihoods(x))
    _close_ll(got, want)
    exact = t.gaussian_log_likelihoods(torch.tensor(x)).numpy()
    # min_eval_gauss = 4: one cluster of four, the lower of the tie
    lead = np.argmax(cll.numpy(), axis=1)
    assert set(lead) <= {0, 1}
    for f, c in enumerate(lead):
        members = np.nonzero(assign == c)[0]
        twins = np.nonzero(assign == c + 2)[0]
        np.testing.assert_allclose(got[f, members], exact[f, members],
                                   atol=1e-5)
        assert not np.allclose(got[f, twins], exact[f, twins], atol=1e-3)


def test_gated_batch_axis():
    """[B, T, D] features give the rows of [T, D] calls."""
    model = random_model(G=24, S=8, D=5, K=3, seed=13)
    _, t = _gated(model, 4, 0.0, 0.2)
    x = torch.tensor(_feats(20, 5, seed=14, scale=1.0)).reshape(2, 10, 5)
    got = t.state_log_likelihoods(x)
    for b in range(2):
        torch.testing.assert_close(got[b], t.state_log_likelihoods(x[b]),
                                   rtol=0, atol=0)


def test_gcl_files(tmp_path):
    assign = np.random.default_rng(15).integers(0, 5, 23).astype(np.int32)
    j_write_gcl(str(tmp_path / "j.gcl"), assign, 5)
    t_write_gcl(str(tmp_path / "t.gcl"), assign, 5)
    assert (tmp_path / "t.gcl").read_text() == (tmp_path / "j.gcl").read_text()
    got, C = t_read_gcl(str(tmp_path / "j.gcl"))
    want, Cj = j_read_gcl(str(tmp_path / "j.gcl"))
    assert C == Cj == 5
    np.testing.assert_array_equal(got, want)


def _cmllr(rng, D, C):
    Ws = []
    for _ in range(C):
        A = np.eye(D) + 0.15 * rng.normal(0, 1, (D, D))
        b = rng.normal(0, 0.5, D)
        Ws.append(np.concatenate([b[:, None], A], axis=1))
    return Ws


@pytest.mark.parametrize("full", [False, True])
def test_apply_model_cmllr(full):
    """The folded model equals the reference's, and its full-covariance
    scorer agrees; a pool with full Gaussians folds them too."""
    rng = np.random.default_rng(16)
    model = (_full_model(seed=17, D=4, G=10, S=4) if full
             else random_model(G=10, S=4, D=4, K=2, seed=1))
    Ws = _cmllr(rng, 4, 3)
    cls = rng.integers(0, 3, 10)
    jm = j_model_cmllr(model, Ws, cls)
    tm = t_model_cmllr(convert.hmm_model(model), Ws, cls)
    assert tm.gauss_kind == jm.gauss_kind == ["full"] * 10
    np.testing.assert_array_equal(tm.means, jm.means)
    for g in range(10):
        np.testing.assert_array_equal(tm.full_covars[g], jm.full_covars[g])
    j, t = JGmm.from_model(jm), TGmm.from_model(tm, device="cpu")
    _check_scorers(j, t, _feats(20, 4, seed=18))


@pytest.mark.parametrize("kind", ["full", "subspace", "gated"])
def test_fused_scorer_refuses_other_models(kind):
    """`FusedGmmScorer.from_scorer` takes plain diagonal scorers only, as
    the Pallas scorer does, instead of building slabs from the wrong
    tables."""
    if kind == "full":
        scorer = _both(_full_model())[1]
    elif kind == "subspace":
        scorer = TGmm.from_model(convert.hmm_model(_pool_with_pcgmm(
            np.random.default_rng(21))), device="cpu")
        assert scorer.sub_basis
    else:
        scorer = _gated(random_model(G=20, S=5, D=4, K=2), 3, 0.0, 0.2)[1]
    with pytest.raises(ValueError, match="plain diagonal GMMs only"):
        TFused.from_scorer(scorer)
