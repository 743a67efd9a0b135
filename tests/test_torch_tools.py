"""PyTorch port, the host tools: `lex2fst`, `lexdebug`, `hmm2fsm`,
`cmpmodel`, `gconvert`, `lna_tool`, `wer`, `playseg`, `batch_run`,
`perplexity` and `native/`, each against the JAX package's tool on the
same files (CPU), byte for byte: every case of `tests/test_misc_tools.py`,
`test_playseg.py`, `test_native.py`, `test_batch_run_condor.py` and
`test_batch_run_slurm.py`.  Then `tests/test_e2e_wer.py`'s train ->
recognize -> wer loop through the port (``--device cpu``) for both
engines, the JAX package's run beside it: the same hypotheses and the
same WER lines (0%), the trained models within the training CLIs'
tolerance (`tests/test_torch_train_cli.py`: rtol 2e-3).
"""

import io
import os
import stat
import sys
import wave
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from aaltoasr_tpu import native as j_native
from aaltoasr_tpu.cli import batch_run as j_batch
from aaltoasr_tpu.cli import cmpmodel as j_cmpmodel
from aaltoasr_tpu.cli import gconvert as j_gconvert
from aaltoasr_tpu.cli import hmm2fsm as j_hmm2fsm
from aaltoasr_tpu.cli import lex2fst as j_lex2fst
from aaltoasr_tpu.cli import lexdebug as j_lexdebug
from aaltoasr_tpu.cli import lna_tool as j_lna_tool
from aaltoasr_tpu.cli import perplexity as j_perplexity
from aaltoasr_tpu.cli import playseg as j_playseg
from aaltoasr_tpu.cli import recognize as j_recognize
from aaltoasr_tpu.cli import train as j_train
from aaltoasr_tpu.cli import wer as j_wer
from aaltoasr_tpu.decoder.classes import WordClasses as JClasses
from aaltoasr_tpu.decoder.morpheus import Morpheus as JMorpheus
from aaltoasr_tpu.formats import model_io as j_mio
from aaltoasr_tpu.formats.arpa import read_arpa as j_read_arpa

from aaltoasr_tpu_torch import native as t_native
from aaltoasr_tpu_torch.cli import batch_run as t_batch
from aaltoasr_tpu_torch.cli import cmpmodel as t_cmpmodel
from aaltoasr_tpu_torch.cli import gconvert as t_gconvert
from aaltoasr_tpu_torch.cli import hmm2fsm as t_hmm2fsm
from aaltoasr_tpu_torch.cli import lex2fst as t_lex2fst
from aaltoasr_tpu_torch.cli import lexdebug as t_lexdebug
from aaltoasr_tpu_torch.cli import lna_tool as t_lna_tool
from aaltoasr_tpu_torch.cli import perplexity as t_perplexity
from aaltoasr_tpu_torch.cli import playseg as t_playseg
from aaltoasr_tpu_torch.cli import recognize as t_recognize
from aaltoasr_tpu_torch.cli import train as t_train
from aaltoasr_tpu_torch.cli import wer as t_wer
from aaltoasr_tpu_torch.decoder.classes import WordClasses as TClasses
from aaltoasr_tpu_torch.decoder.morpheus import Morpheus as TMorpheus
from aaltoasr_tpu_torch.formats import model_io as t_mio
from aaltoasr_tpu_torch.formats.arpa import read_arpa as t_read_arpa
from aaltoasr_tpu_torch.formats.lna import write_lna
from aaltoasr_tpu_torch.formats.treegram_bin import write_bin

from tests import test_batch_run_condor, test_batch_run_slurm
from tests.test_decoder import ARPA_TEXT
from tests.test_e2e_wer import CFG as E2E_CFG
from tests.test_e2e_wer import _init_model, _write_corpus
from tests.test_gmm import random_model
from tests.test_golden_estimate import assert_models_close
from tests.test_misc_tools import MORPH_ARPA
from tests.test_subspaces import _toy_model
from tests.test_train import three_state_model

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]


def _run(main, argv) -> tuple[int, str]:
    """(return code, standard output) of a CLI's ``main``."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _same_output(jmain, tmain, argv) -> str:
    """Both CLIs on ``argv``: the same return code and standard output."""
    want, got = _run(jmain, argv), _run(tmain, argv)
    assert got == want
    return got[1]


def test_every_cli_ported():
    """The port has a counterpart of each of the JAX package's CLIs."""
    def clis(pkg):
        return {p.stem for p in (ROOT / pkg / "cli").glob("*.py")
                if p.stem != "__init__"}
    assert len(clis("aaltoasr_tpu")) == 42
    assert clis("aaltoasr_tpu_torch") == clis("aaltoasr_tpu")


# -- test_misc_tools.py ------------------------------------------------------

@pytest.mark.parametrize("word", ["talossa", "taloa", "aa", "xyz"])
def test_morpheus_identical(word):
    j = JMorpheus(j_read_arpa(MORPH_ARPA))
    t = TMorpheus(t_read_arpa(MORPH_ARPA))
    if word == "xyz":
        for m in (j, t):
            with pytest.raises(ValueError):
                m.segment(word)
    else:
        assert t.segment(word) == j.segment(word)


def test_word_classes_identical():
    text = "C1 0.5 hello\nC2 world\nNUM 0.25 yksi\n"
    j, t = JClasses.read(text), TClasses.read(text)
    assert t.membership == j.membership
    assert t.membership["hello"][1] == pytest.approx(np.log(0.5))
    names = ["yksi", "kaksi", "world"]
    assert t.lm_word_names(names) == j.lm_word_names(names) == \
        ["NUM", "kaksi", "C2"]


def _shard_job(d: Path) -> Path:
    """`TestBatchRun`'s job: shard 2 fails on its first attempt only."""
    d.mkdir()
    script = d / "job.py"
    script.write_text(
        "import sys, os\n"
        f"d = {str(d)!r}\n"
        "i = sys.argv[1]\n"
        "flag = os.path.join(d, 'fail' + i)\n"
        "open(os.path.join(d, 'out' + i), 'a').write('x')\n"
        "if i == '2' and not os.path.exists(flag):\n"
        "    open(flag, 'w').write('1')\n"
        "    sys.exit(3)\n")
    return script


def test_batch_run_local_identical(tmp_path):
    """Local shards with a retry: the same runs in both packages."""
    outs = {}
    for name, main in (("j", j_batch.main), ("t", t_batch.main)):
        d = tmp_path / name
        script = _shard_job(d)
        assert main(["-B", "3", "--retries", "1", "--failed-list",
                     str(d / "failed.lst"), "--", sys.executable,
                     str(script), "{I}"]) == 0
        outs[name] = [(d / f"out{i}").read_text() for i in (1, 2, 3)]
        assert not (d / "failed.lst").exists()
    assert outs["t"] == outs["j"] == ["x", "xx", "x"]


@pytest.mark.parametrize("seed", [0, 1])
def test_perplexity_identical(tmp_path, seed):
    """`TestPerplexity`'s LM and text, then a longer text with an OOV
    word through an interpolation with a binary TreeGram (`--mix`,
    `InterTreeGram`)."""
    (tmp_path / "lm.arpa").write_text(ARPA_TEXT)
    text = tmp_path / "t.txt"
    if seed == 0:
        text.write_text("yksi kaksi\n")
        argv = ["-l", str(tmp_path / "lm.arpa"), str(text)]
    else:
        rng = np.random.default_rng(seed)
        words = ["yksi", "kaksi", "kolme", "nelja"]
        text.write_text("".join(" ".join(rng.choice(words, 6)) + "\n"
                                for _ in range(5)))
        write_bin(t_read_arpa(ARPA_TEXT), str(tmp_path / "lm.bin"))
        argv = ["-l", str(tmp_path / "lm.arpa"), "--mix",
                str(tmp_path / "lm.bin"), "0.3", str(text)]
    out = _same_output(j_perplexity.main, t_perplexity.main, argv)
    assert "perplexity:" in out


def test_fst_tools_identical(tmp_path):
    """`TestFstTools`: lex2fst (with and without the loop back to the
    start) and hmm2fsm write the same bytes."""
    (tmp_path / "lex").write_text("yksi a b\nkaksi b a\n")
    j_mio.write_model(str(tmp_path / "m"), three_state_model())
    runs = [(j_lex2fst.main, t_lex2fst.main, [str(tmp_path / "lex")]),
            (j_hmm2fsm.main, t_hmm2fsm.main, ["-b", str(tmp_path / "m")])]
    for k, (jmain, tmain, argv) in enumerate(runs):
        for extra in ([], ["--no-loop"]) if k == 0 else ([],):
            for name, main in (("j", jmain), ("t", tmain)):
                assert main(argv + extra + ["-o", str(
                    tmp_path / f"{name}{k}.fst")]) in (0, None)
            want = (tmp_path / f"j{k}.fst").read_bytes()
            assert want and (tmp_path / f"t{k}.fst").read_bytes() == want


# -- lexdebug, cmpmodel, gconvert, lna_tool, wer ----------------------------

@pytest.mark.parametrize("arcs", [False, True])
def test_lexdebug_identical(tmp_path, arcs):
    j_mio.write_model(str(tmp_path / "m"), three_state_model())
    (tmp_path / "lex").write_text("aa a\nab a a\n_ _\n")
    out = _same_output(j_lexdebug.main, t_lexdebug.main,
                       ["-b", str(tmp_path / "m"), "-l", str(tmp_path / "lex")]
                       + (["--arcs"] if arcs else []))
    assert "nodes:" in out


@pytest.mark.parametrize("same", [False, True])
def test_cmpmodel_identical(tmp_path, same):
    m1 = random_model(G=8, S=3, D=4, K=2, seed=1)
    m2 = random_model(G=8, S=3, D=4, K=2, seed=2)
    j_mio.write_model(str(tmp_path / "a"), m1)
    j_mio.write_model(str(tmp_path / "b"), m1 if same else m2)
    out = _same_output(j_cmpmodel.main, t_cmpmodel.main,
                       [str(tmp_path / "a"), str(tmp_path / "b")])
    assert "symmetric KL" in out
    # models of other shapes are refused alike
    j_mio.write_model(str(tmp_path / "c"), random_model(G=5, S=2, D=4))
    _same_output(j_cmpmodel.main, t_cmpmodel.main,
                 [str(tmp_path / "a"), str(tmp_path / "c")])


@pytest.mark.parametrize("flags", [["-d"], ["-f"], ["--to-pcgmm"],
                                   ["--to-scgmm"]])
def test_gconvert_identical(tmp_path, flags):
    """A full-covariance model converted by both tools: the same files
    (`--to-pcgmm`/`--to-scgmm` over full-dimensional subspaces, as in
    `tests/test_torch_scoring.py`)."""
    j_mio.write_model(str(tmp_path / "in"),
                      _toy_model(np.random.default_rng(7)))
    if flags[0] in ("--to-pcgmm", "--to-scgmm"):
        dvec = 4 * 5 // 2
        flags = flags + ["--ssdim", str(dvec if "pcgmm" in flags[0]
                                        else 4 + dvec)]
    for name, main in (("j", j_gconvert.main), ("t", t_gconvert.main)):
        assert main(["-b", str(tmp_path / "in"), "-o", str(tmp_path / name)]
                    + flags) == 0
    for ext in ("ph", "gk", "mc"):
        want = (tmp_path / f"j.{ext}").read_bytes()
        assert (tmp_path / f"t.{ext}").read_bytes() == want


@pytest.mark.parametrize("flags", [[], ["-n", "3"], ["--argmax"]])
def test_lna_tool_identical(tmp_path, flags):
    lp = np.log(np.random.default_rng(3).dirichlet(np.ones(7), 12)).astype(
        np.float32)
    write_lna(str(tmp_path / "x.lna"), lp)
    out = _same_output(j_lna_tool.main, t_lna_tool.main,
                       [str(tmp_path / "x.lna")] + flags)
    assert out


def test_wer_align_counts_identical():
    cases = [(list("abc"), list("abc")), (["x", "y"], ["x", "z"]),
             (["x", "y"], ["x"]), (["x"], ["x", "y"]),
             ("kitten", "sitting")]
    for ref, hyp in cases:
        assert t_wer.align_counts(ref, hyp) == j_wer.align_counts(ref, hyp)
    assert sum(t_wer.align_counts("kitten", "sitting")) == 3


@pytest.mark.parametrize("flags", [[], ["--utt"], ["--letters", "--utt"]])
def test_wer_cli_identical(tmp_path, capsys, flags):
    (tmp_path / "ref").write_text("u0 yksi kaksi kolme\nu1 kaksi\n"
                                  "u2 kolme kolme\n")
    (tmp_path / "hyp").write_text("yksi kolme kolme (u0)\n (u1)\n"
                                  "kolme kolme yksi (u2)\n")
    argv = ["-r", str(tmp_path / "ref"), "--hyp", str(tmp_path / "hyp")]
    out = _same_output(j_wer.main, t_wer.main, argv + flags)
    assert ("LER" if flags[:1] == ["--letters"] else "WER") in out


# -- test_playseg.py ---------------------------------------------------------

def _wav(path, sig, rate=16000, channels=1):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(sig.astype("<i2").tobytes())


def _playseg(main, monkeypatch, stdin, argv):
    monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    return main(argv)


def test_playseg_wav_dir_identical(tmp_path, monkeypatch, capsys):
    sig = (np.arange(8000) % 256 * 100 - 12800).astype(np.int16)
    _wav(tmp_path / "a.wav", sig)
    stdin = (f"{tmp_path}/a.wav\n0 1600 _\n1600 4800 a\n"
             "9999999 10000000 out_of_range\nbogus line here\n"
             f"{tmp_path}/missing.wav\n0 10 x\n")
    errs = []
    for name, main in (("j", j_playseg.main), ("t", t_playseg.main)):
        assert _playseg(main, monkeypatch, stdin,
                        ["--wav", str(tmp_path / name)]) == 0
        errs.append(capsys.readouterr().err)
    assert errs[1] == errs[0] and "skipping" in errs[0]
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and len(names) == 2
    for n in names:
        assert (tmp_path / "t" / n).read_bytes() == \
            (tmp_path / "j" / n).read_bytes()
    with wave.open(str(tmp_path / "t" / "seg0001.wav")) as w:
        data = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    assert np.array_equal(data, sig[1600:4800])


def test_playseg_raw_output_identical(tmp_path, monkeypatch):
    sig = np.linspace(-30000, 30000, 4000).astype(np.int16)
    _wav(tmp_path / "b.wav", sig)
    stdin = f"{tmp_path}/b.wav\n0 1000\n1000 2000\n"
    for name, main in (("j", j_playseg.main), ("t", t_playseg.main)):
        assert _playseg(main, monkeypatch, stdin,
                        ["-O", str(tmp_path / f"{name}.raw")]) == 0
    got = (tmp_path / "t.raw").read_bytes()
    assert got == (tmp_path / "j.raw").read_bytes()
    assert np.array_equal(np.frombuffer(got, "<i2"), sig[:2000])


# -- test_native.py ----------------------------------------------------------

@pytest.fixture(scope="module")
def libs():
    if j_native.get_lib() is None or t_native.get_lib() is None:
        pytest.skip("native library unavailable (no g++)")


def test_native_builds_under_build_dir(libs):
    """The port's library is built into build/native/, not next to its
    source."""
    lib = t_native.get_lib()
    assert Path(lib._name).parent == ROOT / "build" / "native"
    assert not list((ROOT / "aaltoasr_tpu_torch" / "native").glob("*.so"))


def test_native_lna_codec_identical(libs):
    rng = np.random.default_rng(0)
    lp = -rng.uniform(0, 40, 10000).astype(np.float32)
    lp[::97] = -36.5
    lp[::101] = 0.0
    enc = t_native.lna_encode_u16(lp)
    assert enc == j_native.lna_encode_u16(lp)
    payload = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    np.testing.assert_array_equal(t_native.lna_decode_u16(payload),
                                  j_native.lna_decode_u16(payload))
    grid = np.linspace(-35.9, 0, 1000).astype(np.float32)
    dec = t_native.lna_decode_u16(t_native.lna_encode_u16(grid))
    assert np.abs(dec - grid).max() < 1.0 / 1820.0


@pytest.mark.parametrize("channels,rate", [(1, 16000), (2, 8000)])
def test_native_wav_read_identical(libs, tmp_path, channels, rate):
    rng = np.random.default_rng(2)
    sig = rng.integers(-30000, 30000, 5000 * channels).astype("<i2")
    _wav(tmp_path / "x.wav", sig, rate, channels)
    got, got_rate = t_native.wav_read(str(tmp_path / "x.wav"))
    want, want_rate = j_native.wav_read(str(tmp_path / "x.wav"))
    assert got_rate == want_rate == rate
    np.testing.assert_array_equal(got, want)
    if channels == 1:
        np.testing.assert_array_equal(got, sig.astype(np.float32))


# -- test_batch_run_slurm.py and test_batch_run_condor.py --------------------

def test_slurm_script_identical():
    cmd = ["python", "work.py", "-B", "{B}", "-I", "{I}"]
    s = t_batch.slurm_script(cmd, 8, "failed.lst", "logs", "--mem-per-cpu=8G")
    assert s == j_batch.slurm_script(cmd, 8, "failed.lst", "logs",
                                     "--mem-per-cpu=8G")
    assert "#SBATCH --array=1-8" in s and "-B 8 -I ${SLURM_ARRAY_TASK_ID}" in s


@pytest.mark.parametrize("ids,batches", [([1, 2, 3, 4], 4), ([2, 7], 8)])
def test_condor_files_identical(tmp_path, ids, batches):
    cmd = ["python", "work.py", "-B", "{B}", "-I", "{I}"]
    got = t_batch.condor_files(cmd, ids, batches, "failed.lst", str(tmp_path))
    assert got == j_batch.condor_files(cmd, ids, batches, "failed.lst",
                                       str(tmp_path))
    assert f"queue {len(ids)}" in got[0]


@pytest.mark.parametrize("submit", ["slurm", "condor"])
def test_batch_run_dry_run_identical(tmp_path, capsys, submit):
    outs = []
    for name, main in (("j", j_batch.main), ("t", t_batch.main)):
        d = tmp_path / name
        assert main(["-B", "4", "--submit", submit, "--dry-run",
                     "--log-dir", str(d / "logs"),
                     "--failed-list", str(d / "f.lst"),
                     "--", "echo", "{I}"]) == 0
        outs.append(capsys.readouterr().out.replace(str(d), "<dir>"))
        files = sorted(os.listdir(d / "logs"))
        assert files and files == sorted(os.listdir(tmp_path / "j" / "logs"))
        for f in files:
            assert (d / "logs" / f).read_text().replace(str(d), "<dir>") == \
                (tmp_path / "j" / "logs" / f).read_text().replace(
                    str(tmp_path / "j"), "<dir>")
    assert outs[1] == outs[0]


def _flaky_worker(d: Path, state: Path) -> Path:
    """A worker whose batch 2 fails until ``state`` exists."""
    worker = d / "work.sh"
    worker.write_text(f"""#!/bin/bash
i="$1"
echo "$i" >> {d / "ran"}
if [ "$i" = "2" ] && [ ! -f {state} ]; then
  touch {state}
  exit 1
fi
exit 0
""")
    worker.chmod(worker.stat().st_mode | stat.S_IEXEC)
    return worker


@pytest.mark.parametrize("submit,retries,want_rc,want_runs", [
    ("slurm", 1, 0, ["1", "2", "3", "2"]),
    ("condor", 1, 0, ["1", "2", "3", "2"]),
    ("condor", 0, 1, ["1", "2", "3"])])
def test_batch_run_submit_retry_identical(tmp_path, monkeypatch, submit,
                                          retries, want_rc, want_runs):
    """Each package's `batch_run` against the fake scheduler of the JAX
    tests: the same runs, the same failed list."""
    path = os.environ["PATH"]
    for name, main in (("j", j_batch.main), ("t", t_batch.main)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.setenv("PATH", path)
        if submit == "slurm":
            state = test_batch_run_slurm.TestSlurmSubmitRetry()._fake_sbatch(
                d, monkeypatch)
        else:
            test_batch_run_condor.TestCondorSubmitRetry()._fake_condor(
                d, monkeypatch)
            state = d / "round"
        # with no retry left, batch 2 stays failed
        worker = _flaky_worker(d, state)
        monkeypatch.chdir(d)
        assert main(["-B", "3", "--submit", submit, "--retries",
                     str(retries), "--log-dir", str(d / "logs"),
                     "--failed-list", str(d / "f.lst"),
                     "--", "bash", str(worker), "{I}"]) == want_rc
        assert (d / "ran").read_text().split() == want_runs
        if want_rc:
            assert (d / "f.lst").read_text().split() == ["2"]
        else:
            assert not (d / "f.lst").exists()


# -- test_e2e_wer.py: train -> recognize -> wer ------------------------------

UTTS = [("u0", ["_", "a", "_"]), ("u1", ["_", "b", "_"]),
        ("u2", ["_", "a", "b", "_"]), ("u3", ["_", "b", "a", "_"]),
        ("u4", ["_", "a", "_", "a", "_"])]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """`test_e2e_wer.py`'s corpus and rough init, trained three
    iterations by each package's `train` (the port on the CPU)."""
    root = tmp_path_factory.mktemp("e2e")
    rng = np.random.default_rng(17)
    recipe = _write_corpus(root, rng, UTTS)
    (root / "feats.cfg").write_text(E2E_CFG)
    init = _init_model(root, rng)
    for name, main in (("j", j_train.main), ("t", t_train.main)):
        assert main(["-b", init, "-c", str(root / "feats.cfg"),
                     "-r", str(recipe), "-w", str(root / f"work_{name}"),
                     "--id", "m", "--num-iters", "3", "-i", "0"]
                    + (CPU if name == "t" else [])) in (0, None)
    assert_models_close(j_mio.read_model(str(root / "work_j" / "m_3")),
                        t_mio.read_model(str(root / "work_t" / "m_3")),
                        rtol=2e-3)
    (root / "lex.txt").write_text("aa a\nbee b\n_ _\n")
    vocab = ["<s>", "</s>", "aa", "bee"]
    (root / "lm.arpa").write_text(
        "\\data\\\nngram 1=4\n\n\\1-grams:\n"
        + "".join(f"-0.6 {w}\n" for w in vocab) + "\n\\end\\\n")
    word_of = {"a": "aa", "b": "bee"}
    (root / "ref.trn").write_text("".join(
        " ".join(word_of[p] for p in phones if p in word_of)
        + f" ({name}.lna)\n" for name, phones in UTTS))
    return root, recipe


@pytest.mark.parametrize("engine", ["exact", "dense"])
def test_train_recognize_wer_zero(trained, engine):
    root, recipe = trained
    hyps, wers = {}, {}
    for name, rec, wer in (("j", j_recognize.main, j_wer.main),
                           ("t", t_recognize.main, t_wer.main)):
        rc, out = _run(rec, [
            "-b", str(root / f"work_{name}" / "m_3"),
            "-c", str(root / "feats.cfg"), "-l", str(root / "lex.txt"),
            "-n", str(root / "lm.arpa"), "-r", str(recipe),
            "-w", str(root / f"eval_{engine}_{name}"), "--lm-scale", "1",
            "--duration-scale", "0", "--engine", engine]
            + (CPU if name == "t" else []))
        assert rc in (0, None)
        hyps[name] = [ln for ln in out.splitlines() if ln.endswith(")")]
        hyp = root / f"hyp_{engine}_{name}.trn"
        hyp.write_text("\n".join(hyps[name]) + "\n")
        rc, wers[name] = _run(wer, ["-r", str(root / "ref.trn"),
                                    "--hyp", str(hyp)])
        assert rc == 0
    assert len(hyps["t"]) == len(UTTS) and hyps["t"] == hyps["j"]
    assert wers["t"] == wers["j"]
    line = wers["t"].strip().splitlines()[-1]
    assert float(line.split("%")[0].split(":")[1]) == 0.0, line
