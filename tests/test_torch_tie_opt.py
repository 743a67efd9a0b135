"""PyTorch port, the host-only training tail: decision-tree tying
(`train/tie.py`, the `tie` CLI), gradient optimization
(`train/optimize.py`, `optmodel`) and the constrained-line-search
updates (`train/clsstep.py`, `train/clsstep_kld.py`, `clsstep`,
`clskld`), each against the JAX package on the same numpy inputs (CPU).

Every case of `tests/test_tie.py`, `test_optimize.py` and
`test_clsstep.py` runs through both packages.  The modules are host
copies, so their outputs are identical: trees, basebinds and model files
byte for byte, `criterion_grad` within rtol 1e-6 (the reference's own
tolerance against autodiff), L-BFGS state files member for member.

The `tie` CLI is held against the JAX CLI on the corpus and rules of
`tests/test_golden_tie.py` (that test needs the reference's `aku` tree):
on the same features (the reference generator's, through
`same_features`) the basebind and model are byte-identical; on the
port's own frontend (float32 noise, ~1e-5) the tied-state partition is
identical.
"""

import copy
import io
import zipfile
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from aaltoasr_tpu.cli import clskld as j_clskld
from aaltoasr_tpu.cli import clsstep as j_clsstep_cli
from aaltoasr_tpu.cli import optmodel as j_optmodel
from aaltoasr_tpu.cli import tie as j_tie_cli
from aaltoasr_tpu.formats import model_io as j_mio
from aaltoasr_tpu.models.hmm import TransitionTable as JTable
from aaltoasr_tpu.train import accumulators as j_acc
from aaltoasr_tpu.train import clsstep as j_cls
from aaltoasr_tpu.train import clsstep_kld as j_kld
from aaltoasr_tpu.train import optimize as j_opt
from aaltoasr_tpu.train import tie as j_tie

from aaltoasr_tpu_torch import convert
from aaltoasr_tpu_torch.cli import clskld as t_clskld
from aaltoasr_tpu_torch.cli import clsstep as t_clsstep_cli
from aaltoasr_tpu_torch.cli import optmodel as t_optmodel
from aaltoasr_tpu_torch.cli import tie as t_tie_cli
from aaltoasr_tpu_torch.formats import model_io as t_mio
from aaltoasr_tpu_torch.models.hmm import TransitionTable as TTable
from aaltoasr_tpu_torch.train import accumulators as t_acc
from aaltoasr_tpu_torch.train import clsstep as t_cls
from aaltoasr_tpu_torch.train import clsstep_kld as t_kld
from aaltoasr_tpu_torch.train import optimize as t_opt
from aaltoasr_tpu_torch.train import tie as t_tie

from tests.test_clsstep import mmi_stats
from tests.test_gmm import random_model
from tests.test_golden_tie import RULES, make_corpus, partition, read_basebind
from tests.test_optimize import fill_random_stats
from tests.test_torch_train_cli import use_reference_features
from tests.test_train import three_state_model

torch.set_num_threads(1)

CPU = ["--device", "cpu"]
PKGS = {"jax": j_tie, "port": t_tie}


def _model_bytes(root, name) -> dict:
    """{extension: bytes} of a model written as ``root/name``."""
    return {ext: (root / f"{name}.{ext}").read_bytes()
            for ext in ("ph", "gk", "mc")}


def _write_both(tmp_path, jm, tm) -> None:
    """Both models written by their own package: identical files."""
    j_mio.write_model(str(tmp_path / "j"), jm)
    t_mio.write_model(str(tmp_path / "t"), tm)
    assert _model_bytes(tmp_path, "j") == _model_bytes(tmp_path, "t")


# -- train/tie.py ------------------------------------------------------------

@pytest.mark.parametrize("label", ["a-b+c", "b", "a-b", "b+c", "x-a-b+c+d"])
def test_label_helpers(label):
    for name in ("center_phone", "left_contexts", "right_contexts"):
        assert getattr(t_tie, name)(label) == getattr(j_tie, name)(label)


def _tie_pool(tie, seed=0):
    """`tests/test_tie.py`'s pool: center 'a' with vowel and stop left
    contexts whose statistics differ."""
    rng = np.random.default_rng(seed)
    pool = tie.PhonePool(dim=3)
    pool.load_rules("VOWEL context e,i,o\nSTOP context k,p,t\n")
    pool.min_occupancy = 10
    pool.min_split_gain = 1.0
    for left in ["e", "i", "o", "k", "p", "t"]:
        shift = 4.0 if left in "eio" else -4.0
        cp = pool.get_context_phone(f"{left}-a+n", 0)
        cp.add(np.ones(40), rng.normal(shift, 1.0, (40, 3)))
    return pool


def _gain_pool(tie):
    """`test_gain_math_matches_formula`'s two separated clusters."""
    pool = tie.PhonePool(dim=1)
    pool.load_rules("L context x\n")
    pool.min_occupancy = 1
    pool.min_split_gain = 0.0
    pool.get_context_phone("x-a", 0).add(np.ones(100),
                                         np.full((100, 1), -2.0))
    pool.get_context_phone("y-a", 0).add(np.ones(100),
                                         np.full((100, 1), 2.0))
    return pool


def _tree(result) -> dict:
    """The tying result as plain data: member labels per cluster."""
    return {k: [[m.label for m in c.members] for c in v]
            for k, v in result.items()}


@pytest.mark.parametrize("case", ["splits", "min_occupancy", "gain"])
def test_phone_pool_ties_identically(tmp_path, case):
    """The same statistics: identical trees, models and basebinds
    (`TestTying`'s cases through both packages)."""
    pools = {}
    for name, tie in PKGS.items():
        pool = _gain_pool(tie) if case == "gain" else _tie_pool(tie)
        if case == "min_occupancy":
            pool.min_occupancy = 1000
        pool.tie()
        pools[name] = pool
    j, t = pools["jax"], pools["port"]
    assert _tree(t.result) == _tree(j.result)
    want = {"splits": None, "min_occupancy": 1, "gain": 2}[case]
    if want is not None:
        assert len(t.result[("a", 0)]) == want
    else:
        assert len(t.result[("a", 0)]) >= 2
    j.save_basebind(str(tmp_path / "j.bb"))
    t.save_basebind(str(tmp_path / "t.bb"))
    assert (tmp_path / "t.bb").read_bytes() == (tmp_path / "j.bb").read_bytes()
    tm = t.make_model()
    _write_both(tmp_path, j.make_model(), tm)
    assert tm.num_states == len(t.result[("a", 0)])


def _merge_pool(tie):
    """`TestMergePass`'s three clusters, two of one distribution."""
    rng = np.random.default_rng(0)
    D = 3
    pool = tie.PhonePool(dim=D)

    def stats_for(center_mu, label):
        st = tie.ContextPhoneStats(label=label)
        for _ in range(50):
            st.add(1.0, center_mu + rng.normal(0, 1, D))
        return st

    a1 = stats_for(np.zeros(D), "x-a+y")
    a2 = stats_for(np.zeros(D), "y-a+x")
    b = stats_for(np.full(D, 8.0), "z-a+z")
    pool.result = {("a", 0): [tie.Cluster([a1]), tie.Cluster([a2]),
                              tie.Cluster([b])]}
    return pool


@pytest.mark.parametrize("loss,merged", [(60.0, 1), (1e-6, 0)])
def test_merge_pass_identical(tmp_path, loss, merged):
    j, t = _merge_pool(j_tie), _merge_pool(t_tie)
    assert t.merge(max_merge_loss=loss) == j.merge(max_merge_loss=loss) \
        == merged
    assert _tree(t.result) == _tree(j.result)
    _write_both(tmp_path, j.make_model(), t.make_model())


# -- the tie CLI -------------------------------------------------------------

def _tie_argv(tmp_path, bind, model, count, sgain):
    return ["-c", str(tmp_path / "feats.cfg"), "-r", str(tmp_path / "recipe"),
            "-u", str(tmp_path / "rules"), "-b", str(tmp_path / bind),
            "-o", str(tmp_path / model), "--count", str(count),
            "--sgain", str(sgain), "--context", "1"]


@pytest.mark.parametrize("count,sgain", [(100, 0.0), (300, 0.0),
                                         (100, 50.0)])
def test_tie_cli_same_features_identical(tmp_path, monkeypatch, count,
                                         sgain):
    """`test_golden_tie.py`'s corpus and settings, on the same features:
    basebind and model byte-identical."""
    make_corpus(tmp_path)
    assert (tmp_path / "rules").read_text() == RULES
    assert j_tie_cli.main(_tie_argv(tmp_path, "j.bind", "j", count,
                                    sgain)) == 0
    use_reference_features(monkeypatch)
    assert t_tie_cli.main(_tie_argv(tmp_path, "t.bind", "t", count, sgain)
                          + CPU) == 0
    assert (tmp_path / "t.bind").read_bytes() == \
        (tmp_path / "j.bind").read_bytes()
    assert _model_bytes(tmp_path, "t") == _model_bytes(tmp_path, "j")


def test_tie_cli_own_frontend_same_partition(tmp_path):
    """Each package's own frontend: the same tied-state partition."""
    make_corpus(tmp_path)
    assert j_tie_cli.main(_tie_argv(tmp_path, "j.bind", "j", 100, 0.0)) == 0
    assert t_tie_cli.main(_tie_argv(tmp_path, "t.bind", "t", 100, 0.0)
                          + CPU) == 0
    want, got = (read_basebind(tmp_path / f"{n}.bind") for n in "jt")
    assert set(got) == set(want)
    for s in range(2):
        assert partition(got, s) == partition(want, s)
    n = len({i for ids in want.values() for i in ids})
    assert n > 2 and len({i for ids in got.values() for i in ids}) == n


# -- train/optimize.py and optmodel ------------------------------------------

def _stats_pair(G=6, S=2, D=3, K=3, seed=0, stats_seed=1):
    """The same model and filled ML statistics in both packages."""
    jm = random_model(G=G, S=S, D=D, K=K, seed=seed)
    tm = convert.hmm_model(jm)
    js = j_acc.HmmStats.zeros(jm, JTable.from_model(jm), j_acc.PDF_ML_STATS)
    ts = t_acc.HmmStats.zeros(tm, TTable.from_model(tm), t_acc.PDF_ML_STATS)
    fill_random_stats(js, jm, stats_seed)
    fill_random_stats(ts, tm, stats_seed)
    return jm, tm, js, ts


@pytest.mark.parametrize("weights", [
    dict(ml_weight=1.0), dict(ml_weight=0.5, gsmooth=0.2, msmooth=0.1)])
def test_criterion_grad_matches(weights):
    """`test_matches_autodiff`'s model and statistics: rtol 1e-6."""
    jm, tm, js, ts = _stats_pair()
    np.testing.assert_allclose(t_opt.criterion_grad(tm, ts, **weights),
                               j_opt.criterion_grad(jm, js, **weights),
                               rtol=1e-6, atol=0)


def test_criterion_grad_matches_autodiff():
    """The port's gradient against jax.grad of the explicit objective
    (the reference's own check, run on the port)."""
    import jax
    import jax.numpy as jnp
    jm, tm, _, ts = _stats_pair()
    b = ts.buffers[t_acc.ML_BUF]
    G, D = tm.means.shape
    sizes = [len(w) for _, w in tm.mixtures]

    def objective(x):
        mu = x[:G * D].reshape(G, D)
        logv = x[G * D:2 * G * D].reshape(G, D)
        p = jnp.exp(-logv)
        gam = jnp.asarray(b.gamma[:G])[:, None]
        m1, m2 = jnp.asarray(b.mean_acc[:G]), jnp.asarray(b.sec_acc[:G])
        F = jnp.sum(-0.5 * gam * logv
                    - 0.5 * (m2 - 2 * mu * m1 + gam * mu * mu) * p)
        off = 2 * G * D
        for s, k in enumerate(sizes):
            logits = x[off:off + k]
            off += k
            F = F + jnp.sum(jnp.asarray(b.mix_gamma[s, :k]) * (
                logits - jax.scipy.special.logsumexp(logits)))
        return F

    jax.config.update("jax_enable_x64", True)
    try:
        want = np.asarray(jax.grad(objective)(jnp.asarray(
            t_opt.pack_params(tm))))
    finally:
        jax.config.update("jax_enable_x64", False)
    np.testing.assert_allclose(t_opt.criterion_grad(tm, ts, ml_weight=1.0),
                               want, rtol=1e-6, atol=1e-8)


def test_pack_roundtrip_identical():
    jm = random_model(G=5, S=2, D=4, K=2, seed=2)
    tm = convert.hmm_model(jm)
    x = t_opt.pack_params(tm)
    np.testing.assert_array_equal(x, j_opt.pack_params(jm))
    m2 = t_opt.unpack_params(tm, x, minvar=1e-8)
    j2 = j_opt.unpack_params(jm, x, minvar=1e-8)
    np.testing.assert_array_equal(m2.means, j2.means)
    np.testing.assert_array_equal(m2.covars, j2.covars)
    np.testing.assert_allclose(m2.covars, tm.covars, rtol=1e-9)
    for (_, w1), (_, w2) in zip(m2.mixtures, j2.mixtures):
        np.testing.assert_array_equal(w1, w2)


def _npz_members(path) -> dict:
    """{member name: bytes} of an .npz (the zip's timestamps aside)."""
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def test_lbfgs_state_files_identical(tmp_path):
    """`test_quadratic_convergence_with_state_roundtrip` through both
    packages: the same iterates, each step's state file identical."""
    rng = np.random.default_rng(3)
    n = 12
    Q = rng.normal(0, 1, (n, n))
    A = Q @ Q.T + np.eye(n)
    bvec = rng.normal(0, 1, n)
    xs = {}
    for name, opt in (("j", j_opt), ("t", t_opt)):
        path = str(tmp_path / f"{name}.osf.npz")
        x = np.zeros(n)
        opt.LbfgsState(max_updates=6, init_scale=0.1).save(path)
        for _ in range(40):
            state = opt.LbfgsState.load(path)
            x = opt.optimization_step(x, bvec - A @ x, state, limit=10.0)
            state.save(path)
        xs[name] = x
    np.testing.assert_array_equal(xs["t"], xs["j"])
    assert np.linalg.norm(xs["t"] - np.linalg.solve(A, bvec)) < 1e-4
    assert _npz_members(tmp_path / "t.osf.npz") == \
        _npz_members(tmp_path / "j.osf.npz")


def test_limit_clips_step_identically():
    grad = np.array([100.0, -50.0, 0.0, 1.0])
    got = t_opt.optimization_step(np.zeros(4), grad,
                                  t_opt.LbfgsState(init_scale=1.0), 0.5)
    want = j_opt.optimization_step(np.zeros(4), grad,
                                   j_opt.LbfgsState(init_scale=1.0), 0.5)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).max() == pytest.approx(0.5, abs=1e-9)


def _optmodel_files(tmp_path):
    """`TestOptmodelCli`'s model and statistics dump, as files."""
    model = random_model(G=6, S=2, D=3, K=3, seed=4)
    table = JTable.from_model(model)
    j_mio.write_model(str(tmp_path / "m0"), model)
    stats = j_acc.HmmStats.zeros(model, table, j_acc.PDF_ML_STATS)
    fill_random_stats(stats, model, 5)
    stats.num_ll = -1234.0
    stats.num_frames = 100
    stats.dump(str(tmp_path / "s0"))
    (tmp_path / "stats.lst").write_text(f"{tmp_path / 's0'}\n")


def test_optmodel_cli_identical(tmp_path):
    """Two iterations of each CLI on the same dumps: models, summaries
    and state files identical."""
    _optmodel_files(tmp_path)
    for name, main in (("j", j_optmodel.main), ("t", t_optmodel.main)):
        for it, extra in ((1, ["-s", str(tmp_path / f"{name}.sum")]),
                          (2, [])):
            base = "m0" if it == 1 else f"{name}1"
            assert main(["-b", str(tmp_path / base),
                         "-L", str(tmp_path / "stats.lst"),
                         "-F", str(tmp_path / f"{name}.osf.npz"),
                         "-o", str(tmp_path / f"{name}{it}"), "--ml", "1.0",
                         "--limit", "0.1"] + extra) == 0
    for it in (1, 2):
        assert _model_bytes(tmp_path, f"t{it}") == \
            _model_bytes(tmp_path, f"j{it}")
    m0, m1 = (t_mio.read_model(str(tmp_path / n)) for n in ("m0", "t1"))
    assert 1e-4 < np.abs(m1.means - m0.means).max() <= 0.1 + 1e-6
    assert (tmp_path / "t.sum").read_text().replace("t1", "j1") == \
        (tmp_path / "j.sum").read_text()
    assert _npz_members(tmp_path / "t.osf.npz") == \
        _npz_members(tmp_path / "j.osf.npz")
    assert len(t_opt.LbfgsState.load(str(tmp_path / "t.osf.npz")).s) >= 1


def test_optmodel_requires_criterion(tmp_path, capsys):
    j_mio.write_model(str(tmp_path / "m"),
                      random_model(G=4, S=2, D=3, K=2, seed=6))
    (tmp_path / "l").write_text("")
    argv = ["-b", str(tmp_path / "m"), "-L", str(tmp_path / "l"),
            "-F", str(tmp_path / "o"), "-o", str(tmp_path / "x")]
    assert j_optmodel.main(argv) == 1
    want = capsys.readouterr().err
    assert t_optmodel.main(argv) == 1
    assert capsys.readouterr().err == want


# -- train/clsstep.py, train/clsstep_kld.py, clsstep and clskld -------------

def _cls_pair(model_seed, stats_seed):
    """`test_clsstep.py`'s model and MMI statistics in both packages."""
    jm = three_state_model(seed=model_seed)
    js = mmi_stats(jm, JTable.from_model(jm), seed=stats_seed)
    return jm, js, convert.hmm_model(jm), convert.hmm_stats(js)


@pytest.mark.parametrize("favored", [False, True])
def test_cls_mixture_step_identical(favored):
    jm, js, tm, ts = _cls_pair(2, 3)
    if favored:
        for s in (js, ts):
            s.buffers[j_acc.ML_BUF].mix_gamma[0] = [50.0, 5.0]
            s.buffers[j_acc.MMI_BUF].mix_gamma[0] = [5.0, 5.0]
    limit = 0.1 if favored else 0.05
    got = t_cls.cls_mixture_step(tm, ts, "mmi", limit)
    want = j_cls.cls_mixture_step(jm, js, "mmi", limit)
    for (gi, gw), (wi, ww) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gw, ww)
        assert gw.sum() == pytest.approx(1.0, abs=1e-6)
    if favored:
        assert got[0][1][0] > np.asarray(tm.mixtures[0][1])[0]


@pytest.mark.parametrize("limit", [0.08, 1e6])
def test_cls_mean_cov_step_identical(limit):
    jm, js, tm, ts = _cls_pair(4, 5)
    got = t_cls.cls_mean_cov_step(tm, ts, "mmi", limit, limit, min_var=0.01)
    want = j_cls.cls_mean_cov_step(jm, js, "mmi", limit, limit, min_var=0.01)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if limit > 1:
        num, den = ts.buffers[t_acc.ML_BUF], ts.buffers[t_acc.MMI_BUF]
        target = ((num.mean_acc - den.mean_acc)
                  / (num.gamma - den.gamma)[:, None])
        np.testing.assert_allclose(got[0], target, rtol=1e-6)
    else:
        assert np.all(got[1] >= 0.01)


def test_kldcs_solvers_identical():
    """`TestKldcs`'s solver cases through both packages."""
    f = lambda p: 1.0 / (1 + p)  # noqa: E731
    assert t_kld.search_lambda(f, 1.0, 0.25) == j_kld.search_lambda(
        f, 1.0, 0.25)
    args = (np.array([0.6, 0.3, 0.1]), np.array([10.0, -2.0, 1.0]),
            np.array([12.0, 4.0, 2.0]), 0.0)
    ts, js = t_kld.CriticalMixtureSolver(*args), j_kld.CriticalMixtureSolver(
        *args)
    for lam in (0.0, 1.0, 10.0, 100.0):
        np.testing.assert_array_equal(ts.solve_weights(lam),
                                      js.solve_weights(lam))
        assert ts.evaluate(lam) == js.evaluate(lam)
    mean0, cov0 = np.array([0.0, 1.0]), np.array([1.0, 2.0])
    tm = t_kld.MeanSolver(mean0, cov0, 5.0, np.array([10.0, -2.0]))
    jm = j_kld.MeanSolver(mean0, cov0, 5.0, np.array([10.0, -2.0]))
    cargs = (mean0, cov0, 5.0, np.array([2.0, 4.0]), np.array([8.0, 12.0]),
             0.01)
    tc, jc = t_kld.CovSolver(*cargs), j_kld.CovSolver(*cargs)
    for lam in (0.0, 100.0, 1e12):
        assert tm.evaluate(lam) == jm.evaluate(lam)
        np.testing.assert_array_equal(tm.solve(lam), jm.solve(lam))
        np.testing.assert_array_equal(tc.solve(lam), jc.solve(lam))


@pytest.mark.parametrize("kldcs", [False, True])
def test_clsstep_cli_identical(tmp_path, kldcs):
    """`test_full_step_writes_model` and `test_full_kldcs_step`: the
    same model files and summaries."""
    jm = three_state_model(seed=8 if kldcs else 6)
    js = mmi_stats(jm, JTable.from_model(jm), seed=9 if kldcs else 7)
    j_mio.write_model(str(tmp_path / "in"), jm)
    js.dump(str(tmp_path / "st"))
    (tmp_path / "st.lst").write_text(f"{tmp_path / 'st'}\n")
    for name, main in (("j", j_clsstep_cli.main), ("t", t_clsstep_cli.main)):
        assert main(["-b", str(tmp_path / "in"), "-L",
                     str(tmp_path / "st.lst"), "-o", str(tmp_path / name),
                     "-M", "MMI", "--limit", "0.1",
                     "-s", str(tmp_path / f"{name}.sum")]
                    + (["--kldcs"] if kldcs else [])) == 0
    assert _model_bytes(tmp_path, "t") == _model_bytes(tmp_path, "j")
    assert (tmp_path / "t.sum").read_text() == (tmp_path / "j.sum").read_text()
    out = t_mio.read_model(str(tmp_path / "t"))
    assert not np.allclose(out.means, jm.means)


def _kld_models(pair):
    """``shifted`` and ``same``: `TestClskld`'s models (means moved by
    0.5; a model against itself); ``cls``: the three-state model against
    a moved copy with other covariances and weights (it has a silence
    phone for the filters)."""
    if pair == "cls":
        m1 = three_state_model(seed=6)
        m2 = copy.deepcopy(m1)
        m2.covars = m1.covars * 1.3
        m2.mixtures = [(i, np.asarray(w)[::-1].copy())
                       for i, w in m1.mixtures]
    else:
        m1 = random_model(G=4, S=2, D=3, K=2, seed=0)
        m2 = copy.deepcopy(m1)
    if pair != "same":
        m2.means = m1.means + 0.5
    return m1, m2


@pytest.mark.parametrize("pair,flags", [
    ("shifted", ["-m"]), ("same", ["-g"]), ("cls", ["-w", "-c"]),
    ("cls", ["-g", "--no-silence"]), ("cls", ["-w", "-m", "--only-silence"])])
def test_clskld_cli_identical(tmp_path, pair, flags):
    """The same lines from both CLIs."""
    for name, m in zip("ab", _kld_models(pair)):
        j_mio.write_model(str(tmp_path / name), m)
    argv = ["--base1", str(tmp_path / "a"), "--base2", str(tmp_path / "b")]
    outs = []
    for main in (j_clskld.main, t_clskld.main):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert main(argv + flags) == 0
        outs.append(buf.getvalue())
    assert outs[1] == outs[0] and outs[0]
    if pair == "same":
        np.testing.assert_allclose([float(v) for v in outs[1].split()], 0.0,
                                   atol=1e-6)
