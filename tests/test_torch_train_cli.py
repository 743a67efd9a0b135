"""PyTorch port, training CLIs: `align`, `stats`, `combine_stats`,
`estimate`, `train`, `dur_est`, `gcluster` and `logl`, each against the
JAX package's CLI on the same files (CPU; the port's device CLIs get
``--device cpu``).  `align` writes the reference's .phn files; the host
tools (`combine_stats`, `estimate`, `dur_est`, `gcluster`) write its
bytes; `stats` and `train` agree within the JAX package's own
tolerances (`tests/test_train.py`, `tests/test_golden_train_loop.py`:
models within `assert_models_close` at rtol 2e-3 over two EM
iterations).  The two cases of `tests/test_train_cli.py` run through the
port's `train`."""

import os

import numpy as np
import pytest
import torch

from aaltoasr_tpu.cli import align as j_align
from aaltoasr_tpu.cli import combine_stats as j_combine
from aaltoasr_tpu.cli import dur_est as j_dur_est
from aaltoasr_tpu.cli import estimate as j_estimate
from aaltoasr_tpu.cli import gcluster as j_gcluster
from aaltoasr_tpu.cli import logl as j_logl
from aaltoasr_tpu.cli import stats as j_stats
from aaltoasr_tpu.cli import train as j_train
from aaltoasr_tpu.formats import model_io as j_mio
from aaltoasr_tpu.models.hmm import TransitionTable
from aaltoasr_tpu.train import accumulators as j_acc

from aaltoasr_tpu_torch.cli import align as t_align
from aaltoasr_tpu_torch.cli import combine_stats as t_combine
from aaltoasr_tpu_torch.cli import dur_est as t_dur_est
from aaltoasr_tpu_torch.cli import estimate as t_estimate
from aaltoasr_tpu_torch.cli import gcluster as t_gcluster
from aaltoasr_tpu_torch.cli import logl as t_logl
from aaltoasr_tpu_torch.cli import stats as t_stats
from aaltoasr_tpu_torch.cli import train as t_train
from aaltoasr_tpu_torch.formats import model_io as t_mio
from aaltoasr_tpu_torch.formats.feaconf import FeatureConfig

from tests.test_golden_estimate import assert_models_close
from tests.test_torch_train import _random_stats, _stats_dumps_close
from tests.test_torch_train import write_corpus
from tests.test_train import three_state_model
from tests.test_train_cli import CFG

torch.set_num_threads(1)

CPU = ["--device", "cpu"]


@pytest.fixture
def same_features(monkeypatch):
    """The port's `FeatureGenerator.features` returns the reference
    generator's features for the same configuration and samples, so the
    training CLIs see the same numbers on both sides (the frontends
    differ at float32 noise, ~1e-5 absolute on these features; their own
    parity is `tests/test_torch_frontend*.py`)."""
    from aaltoasr_tpu.formats.feaconf import FeatureConfig as JConfig
    from aaltoasr_tpu.frontend.generator import FeatureGenerator as JGen
    from aaltoasr_tpu_torch.frontend.generator import FeatureGenerator
    gens = {}

    def features(self, samples, num_samples=None):
        text = self.config.dump()
        if text not in gens:
            gens[text] = JGen(JConfig.parse(text))
        return torch.as_tensor(np.array(gens[text].features(
            np.asarray(samples), num_samples)), device=self.device)

    monkeypatch.setattr(FeatureGenerator, "features", features)


def _task(tmp_path, seed=5, seqs=("_ a _", "a _", "_ a a _")):
    """The model as files (`am`), 4-dim features and a recipe per
    package whose alignment= targets differ (``recipe.j``, ``recipe.t``)."""
    recipe = write_corpus(tmp_path, np.random.default_rng(seed), seqs)
    j_mio.write_model(str(tmp_path / "am"), three_state_model(seed=seed))
    text = recipe.read_text()
    (tmp_path / "recipe.j").write_text(text)
    (tmp_path / "recipe.t").write_text(text.replace(".ali.phn", ".port.phn"))
    return ["-b", str(tmp_path / "am"), "-c", str(tmp_path / "feats.cfg")]


def _load(tmp_path, base, mode=j_acc.PDF_ML_STATS):
    model = j_mio.read_model(str(tmp_path / "am"))
    table = TransitionTable.from_model(model)
    stats = j_acc.HmmStats.zeros(model, table, mode)
    stats.load(str(base), table)
    return stats


def test_align_phn_identical(tmp_path):
    """Each package's own frontend: the same state alignments."""
    model = _task(tmp_path)
    assert j_align.main(model + ["-r", str(tmp_path / "recipe.j")]) == 0
    assert t_align.main(model + ["-r", str(tmp_path / "recipe.t")]
                        + CPU) == 0
    for u in range(3):
        want = (tmp_path / f"u{u}.ali.phn").read_text()
        assert want and (tmp_path / f"u{u}.port.phn").read_text() == want


@pytest.mark.parametrize("opts,golden", [
    ([], True), (["-M", "vit"], True), (["-O"], True),
    (["--device-batch", "2"], True), (["--fullstats"], False)])
def test_stats_dumps_match_reference(tmp_path, same_features, opts, golden):
    """On the same features: dumps within the golden-stats tolerances.
    `--fullstats` runs one utterance per call, where the reference's
    jitted E-step itself moves gamma by ~4e-5 of scale from its batched
    one (the port's agrees with the batched one to ~1e-9): that case is
    held to the tolerances the JAX package holds those two paths to."""
    _stats_case(tmp_path, opts, golden)


def test_stats_with_own_frontend(tmp_path):
    """Each package's own frontend: within the tolerances the JAX
    package holds its batched E-step to against its sequential one."""
    _stats_case(tmp_path, [], golden=False)


def _stats_case(tmp_path, opts, golden):
    model = _task(tmp_path)
    if "-O" in opts:
        assert j_align.main(model + ["-r", str(tmp_path / "recipe.j")]) == 0
    argv = model + ["-r", str(tmp_path / "recipe.j")] + opts
    assert j_stats.main(argv + ["-o", str(tmp_path / "j")]) == 0
    assert t_stats.main(argv + ["-o", str(tmp_path / "t")] + CPU) == 0
    mode = j_acc.PDF_ML_STATS | (j_acc.PDF_ML_FULL_STATS
                                 if "--fullstats" in opts else 0)
    _stats_dumps_close(_load(tmp_path, tmp_path / "t", mode),
                       _load(tmp_path, tmp_path / "j", mode), golden=golden)
    assert ((tmp_path / "t.lls").read_text().splitlines()[-1]
            == (tmp_path / "j.lls").read_text().splitlines()[-1])


def _stats_files(tmp_path, mode, n=2):
    """``n`` dumps of random statistics (the JAX writer) and their list."""
    model = j_mio.read_model(str(tmp_path / "am"))
    table = TransitionTable.from_model(model)
    rng = np.random.default_rng(3)
    bases = []
    for i in range(n):
        _random_stats(model, table, rng, mode).dump(str(tmp_path / f"s{i}"))
        bases.append(str(tmp_path / f"s{i}"))
    (tmp_path / "list").write_text("\n".join(bases) + "\n")
    return str(tmp_path / "list")


def _files(base, exts):
    return [open(f"{base}.{e}", "rb").read() for e in exts]


def test_combine_stats_byte_identical(tmp_path):
    _task(tmp_path)
    lst = _stats_files(tmp_path, j_acc.PDF_ML_STATS)
    for main, out in ((j_combine.main, "j"), (t_combine.main, "t")):
        assert main(["-b", str(tmp_path / "am"), "-L", lst,
                     "-o", str(tmp_path / out)]) == 0
    exts = ("gks", "mcs", "phs", "lls")
    assert _files(tmp_path / "t", exts) == _files(tmp_path / "j", exts)


@pytest.mark.parametrize("opts", [
    ["--ml"], ["--ml", "--split", "--minocc", "2", "--maxmixgauss", "4",
               "--numgauss", "9", "--splitalpha", "0.5"],
    ["--ml", "--delete", "10"], ["--ml", "--mremove", "0.45"],
    ["--mmi", "--ismooth", "1"], ["--mpe", "--limit", "0.05", "-D", "EBWD",
                                  "--write-ebwd", "OUT"]])
def test_estimate_byte_identical(tmp_path, opts):
    """The M-step CLI on the same dumps writes the same model files (and
    EBW D values and summary lines)."""
    _task(tmp_path)
    mode = j_acc.PDF_ML_STATS
    if "--mmi" in opts:
        mode |= j_acc.PDF_MMI_STATS
    if "--mpe" in opts:
        mode |= j_acc.PDF_MPE_NUM_STATS | j_acc.PDF_MPE_DEN_STATS
    lst = _stats_files(tmp_path, mode)
    rng = np.random.default_rng(1)
    (tmp_path / "ebwd").write_text("".join(
        f"{d:g} 0.5 40\n" for d in rng.uniform(0, 5, 6)))
    outs = []
    for main, out in ((j_estimate.main, "j"), (t_estimate.main, "t")):
        argv = [str(tmp_path / "ebwd") if o == "EBWD" else
                str(tmp_path / f"{out}.ebwd") if o == "OUT" else o
                for o in opts]
        assert main(["-b", str(tmp_path / "am"), "-L", lst,
                     "-o", str(tmp_path / out), "-s",
                     str(tmp_path / f"{out}.summary")] + argv) == 0
        extra = [(tmp_path / f"{out}.ebwd").read_bytes()] if "OUT" in opts \
            else []
        summary = (tmp_path / f"{out}.summary").read_text().split(
            " numerator")[1]
        outs.append(_files(tmp_path / out, ("gk", "mc", "ph")) + extra
                    + [summary])
    assert outs[1] == outs[0]


def test_train_matches_reference(tmp_path, same_features):
    """On the same features, two EM iterations with a split, durations and clusters: models
    within `assert_models_close` at rtol 2e-3, the likelihood trajectory
    rel 1e-4, the .dur files atol 1e-4, the same cluster assignment."""
    model = _task(tmp_path, seqs=("_ a _", "a _", "_ a a _", "a a _"))
    common = model[:2] + ["-c", str(tmp_path / "feats.cfg"),
                          "-r", str(tmp_path / "recipe.j"),
                          "--id", "m", "--num-iters", "2",
                          "--split-frequency", "2", "--split-stop-iter", "2",
                          "--split-minocc", "1.0", "--split-maxmixgauss", "4",
                          "--split-alpha", "1.0", "--mllt-start-iter", "0",
                          "--durations", "--dur-mincount", "2",
                          "--keep-sil-durations", "--num-clusters", "3",
                          "-i", "0"]
    assert j_train.main(common + ["-w", str(tmp_path / "j")]) == 0
    assert t_train.main(common + ["-w", str(tmp_path / "t")] + CPU) == 0
    for it in (1, 2):
        ref = j_mio.read_model(str(tmp_path / "j" / f"m_{it}"))
        ours = j_mio.read_model(str(tmp_path / "t" / f"m_{it}"))
        assert ref.num_gaussians == ours.num_gaussians
        assert_models_close(ref, ours, rtol=2e-3)
    assert j_mio.read_model(str(tmp_path / "t" / "m_2")).num_gaussians > 6
    lls = [[float(ln.split()[3]) for ln in
            (tmp_path / d / "m.summary").read_text().splitlines()]
           for d in ("j", "t")]
    np.testing.assert_allclose(lls[1], lls[0], rtol=1e-4)
    dur = [j_mio.read_dur(str(tmp_path / d / "m_2.dur")) for d in ("j", "t")]
    assert np.abs(dur[0]).sum() > 0
    np.testing.assert_allclose(dur[1], dur[0], rtol=0, atol=1e-4)
    gcl = [(tmp_path / d / "m_2.gcl").read_text() for d in ("j", "t")]
    assert gcl[1] == gcl[0]


def test_train_em_with_mllt_split_and_durations(tmp_path):
    """`tests/test_train_cli.py::test_em_with_mllt_split_and_durations`
    through the port's `train`: a full-covariance initial model is
    converted, iteration 3 writes an MLLT config, the likelihood rises."""
    from tests.test_train_cli import write_corpus as corpus
    model = three_state_model(seed=5, D=4)
    model.cov_type = "full_cov"
    model.gauss_kind = ["full"] * model.num_gaussians
    model.full_covars = {g: np.diag(model.covars[g]).copy()
                         for g in range(model.num_gaussians)}
    j_mio.write_model(str(tmp_path / "init"), model)
    (tmp_path / "feats.cfg").write_text(CFG)
    recipe = corpus(tmp_path, np.random.default_rng(5))
    assert t_train.main([
        "-b", str(tmp_path / "init"), "-c", str(tmp_path / "feats.cfg"),
        "-r", str(recipe), "-w", str(tmp_path / "work"), "--id", "m",
        "--num-iters", "4", "--mllt-start-iter", "3", "--mllt-frequency",
        "2", "--split-frequency", "2", "--split-stop-iter", "4",
        "--split-minocc", "0.1", "--durations", "-i", "0"] + CPU) == 0
    conv = t_mio.read_model(str(tmp_path / "work" / "m_0"))
    assert conv.cov_type == "diagonal_cov"
    for it in range(1, 5):
        assert os.path.exists(tmp_path / "work" / f"m_{it}.ph")
    cfg3 = FeatureConfig.load(str(tmp_path / "work" / "m_3.cfg"))
    A = np.asarray(cfg3.by_name["mllt"].config.get_float_vec(
        "matrix")).reshape(4, 4)
    assert not np.allclose(A, np.eye(4))
    assert abs(np.linalg.det(A)) > 1e-3
    assert os.path.exists(tmp_path / "work" / "m_4.dur")
    lls = [float(ln.split()[3]) for ln in
           (tmp_path / "work" / "m.summary").read_text().splitlines()]
    assert lls[-1] > lls[0]


def test_train_resume_skips_finished_iterations(tmp_path):
    from tests.test_train_cli import write_corpus as corpus
    j_mio.write_model(str(tmp_path / "init"), three_state_model(seed=6, D=4))
    (tmp_path / "feats.cfg").write_text(CFG)
    recipe = corpus(tmp_path, np.random.default_rng(6), n_utts=2)
    common = ["-b", str(tmp_path / "init"), "-c", str(tmp_path / "feats.cfg"),
              "-r", str(recipe), "-w", str(tmp_path / "work"), "--id", "m",
              "--num-iters", "2", "--mllt-start-iter", "0",
              "--split-frequency", "0", "-i", "0"] + CPU
    assert t_train.main(common) == 0
    mtime = os.path.getmtime(tmp_path / "work" / "m_2.ph")
    assert t_train.main(common) == 0                  # resume: no rewrite
    assert os.path.getmtime(tmp_path / "work" / "m_2.ph") == mtime


def test_dur_est_identical(tmp_path):
    model = _task(tmp_path)
    assert j_align.main(model + ["-r", str(tmp_path / "recipe.j")]) == 0
    for main, out in ((j_dur_est.main, "j.dur"), (t_dur_est.main, "t.dur")):
        assert main(["-b", str(tmp_path / "am"), "-r",
                     str(tmp_path / "recipe.j"), "-O", "--min-count", "1",
                     "-o", str(tmp_path / out)]) == 0
    want = (tmp_path / "j.dur").read_text()
    assert want == (tmp_path / "t.dur").read_text()
    np.testing.assert_allclose(t_mio.read_dur(str(tmp_path / "t.dur")),
                               j_mio.read_dur(str(tmp_path / "j.dur")),
                               atol=1e-4)


@pytest.mark.parametrize("opts", [[], ["--fast"], ["-t", "2"]])
def test_gcluster_identical(tmp_path, opts):
    from aaltoasr_tpu_torch.synth import random_model
    j_mio.write_model(str(tmp_path / "m"), random_model(G=60, S=8, D=5, K=3))
    for main, out in ((j_gcluster.main, "j.gcl"),
                      (t_gcluster.main, "t.gcl")):
        assert main(["-b", str(tmp_path / "m"), "-C", "7",
                     "-o", str(tmp_path / out)] + opts) == 0
    assert (tmp_path / "t.gcl").read_text() == (tmp_path / "j.gcl").read_text()


@pytest.mark.parametrize("mode", ["bw", "vit"])
def test_logl_matches_reference(tmp_path, capsys, same_features, mode):
    model = _task(tmp_path)
    outs = []
    for main, extra in ((j_logl.main, []), (t_logl.main, CPU)):
        assert main(model + ["-r", str(tmp_path / "recipe.j"), "-M", mode]
                    + extra) == 0
        outs.append(capsys.readouterr().out.split())
    assert outs[1][1] == outs[0][1]                    # frames
    assert float(outs[1][0]) == pytest.approx(float(outs[0][0]), rel=1e-5)
