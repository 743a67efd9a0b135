"""PyTorch port, host side: the copied format readers against files the
JAX package writes, the numpy synthetic tasks against the benchmark's,
and a check that no module of the port imports jax."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

from aaltoasr_tpu.formats import model_io as J_io
from aaltoasr_tpu.formats.arpa import write_arpa as j_write_arpa
from aaltoasr_tpu.formats.feaconf import FeatureConfig as JConfig
from aaltoasr_tpu.formats.lna import read_lna as j_read_lna
from aaltoasr_tpu.formats.lna import write_lna as j_write_lna
from aaltoasr_tpu.formats.recipe import Recipe as JRecipe

from aaltoasr_tpu_torch import synth
from aaltoasr_tpu_torch.formats import model_io as T_io
from aaltoasr_tpu_torch.formats.arpa import read_arpa as t_read_arpa
from aaltoasr_tpu_torch.formats.feaconf import FeatureConfig as TConfig
from aaltoasr_tpu_torch.formats.lna import read_lna as t_read_lna
from aaltoasr_tpu_torch.formats.recipe import Recipe as TRecipe
from aaltoasr_tpu_torch.frontend.audio import read_audio as t_read_audio

from tests.test_frontend import cfg_mfcc_full
from tests.test_train import three_state_model

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "benchmarks"))
sys.path.insert(0, str(ROOT))
import bench_decode  # noqa: E402
import __graft_entry__ as graft  # noqa: E402


def _same_model(a, b):
    assert (a.dim, a.cov_type) == (b.dim, b.cov_type)
    np.testing.assert_array_equal(a.means, b.means)
    np.testing.assert_array_equal(a.covars, b.covars)
    assert len(a.mixtures) == len(b.mixtures)
    for (ia, wa), (ib, wb) in zip(a.mixtures, b.mixtures):
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(wa, wb)
    assert [(p.label, list(p.states)) for p in a.phones] == [
        (p.label, list(p.states)) for p in b.phones]
    assert a.transitions == b.transitions
    if a.durations is None:
        assert b.durations is None
    else:
        np.testing.assert_array_equal(a.durations, b.durations)


class TestFormats:
    def test_model_files_round_trip(self, tmp_path):
        model = three_state_model(seed=2, D=4)
        model.durations = np.array([[2.0, 1.5], [3.25, 0.5], [1.5, 2.0]])
        J_io.write_model(str(tmp_path / "am"), model)
        got = T_io.read_model(str(tmp_path / "am"), read_durations=True)
        _same_model(J_io.read_model(str(tmp_path / "am"),
                                    read_durations=True), got)
        # and the port's writers are read back by the reference
        T_io.write_model(str(tmp_path / "am2"), got)
        _same_model(J_io.read_model(str(tmp_path / "am2"),
                                    read_durations=True), got)

    def test_lna_round_trip(self, tmp_path):
        rng = np.random.default_rng(0)
        lp = -np.abs(rng.normal(0, 10, (17, 9))).astype(np.float32)
        lp[0, 0] = -50.0
        for nbytes in (1, 2, 4):
            path = tmp_path / f"x{nbytes}.lna"
            j_write_lna(str(path), lp, nbytes)
            got, nb = t_read_lna(str(path))
            assert nb == nbytes
            np.testing.assert_array_equal(got, j_read_lna(str(path))[0])

    def test_recipe_and_config(self, tmp_path):
        text = ("audio=/a/1.wav lna=/l/1.lna speaker=s1 utterance=u1\n"
                "# comment\n"
                "audio=/a/2.wav start-time=1.5 end-time=2.0\n"
                "audio=/a/3.wav speaker=s2\n")
        (tmp_path / "r.recipe").write_text(text)
        for args in ((), (2, 1), (2, 2)):
            j = JRecipe.read(str(tmp_path / "r.recipe"), *args)
            t = TRecipe.read(str(tmp_path / "r.recipe"), *args)
            assert [vars(i) for i in t] == [vars(i) for i in j]
        JConfig.parse(cfg_mfcc_full()).save(str(tmp_path / "f.cfg"))
        assert (TConfig.load(str(tmp_path / "f.cfg")).dump()
                == JConfig.load(str(tmp_path / "f.cfg")).dump())

    def test_arpa_and_audio(self, tmp_path):
        task = synth.synth_task(num_words=12, order=3)
        j_write_arpa(task.arpa, str(tmp_path / "lm.arpa"))
        got = t_read_arpa(str(tmp_path / "lm.arpa"))
        assert got.vocab == task.arpa.vocab and got.order == 3
        for o in (1, 2, 3):
            assert got.ngrams[o].keys() == task.arpa.ngrams[o].keys()
        audio = np.random.default_rng(1).normal(0, 1000, 800)
        synth.write_wav(tmp_path / "a.wav", audio)
        samples, rate = t_read_audio(str(tmp_path / "a.wav"), 16000)
        assert rate == 16000
        np.testing.assert_array_equal(
            samples, np.clip(np.round(audio), -32768, 32767))


class TestSynth:
    def test_random_model_matches_graft_entry(self):
        _same_model(graft._random_model(G=64, S=10, D=39, K=4, seed=3),
                    synth.random_model(G=64, S=10, D=39, K=4, seed=3))
        assert synth.MFCC_CFG == graft._MFCC_CFG

    def test_synth_task_matches_benchmark(self):
        for kw in (dict(num_words=25, order=2),
                   dict(num_words=25, order=3, triphone=True,
                        durations=True)):
            model, tree, fsa = bench_decode.synth_task(**kw)
            info = bench_decode.synth_task.last_info
            task = synth.synth_task(**kw)
            _same_model(model, task.model)
            for f in ("pdf", "dur_state", "arc_tgt", "arc_logp", "we_word",
                      "we_exit_logp", "we_pron_logp", "we_skip_lm",
                      "we_pair", "root_pair_tgt", "root_pair_logp"):
                np.testing.assert_array_equal(getattr(task.tree, f),
                                              getattr(tree, f))
            assert task.tree.vocab == tree.vocab
            np.testing.assert_array_equal(task.fsa.trans_prob,
                                          fsa.trans_prob)
            assert task.info == info
            _, want_words = bench_decode.synth_obs(model, info, 3, 200)
            plan, got_words = synth.synth_obs(task.model, task.info, 3, 200)
            assert got_words == want_words
            assert plan.shape == (3, 200)

    def test_write_task_reads_back(self, tmp_path):
        task = synth.synth_task(num_words=10, order=3, triphone=True,
                                durations=True)
        paths = synth.write_task(task, str(tmp_path), num_wavs=2,
                                 seconds=0.5)
        model = T_io.read_model(paths["am"], read_durations=True)
        np.testing.assert_allclose(model.durations, task.model.durations,
                                   atol=5e-5)       # .dur keeps 4 decimals
        assert [p.label for p in model.phones] == [
            p.label for p in task.model.phones]
        assert len(TRecipe.read(paths["recipe"])) == 2


# the lattice entry points, called once each (their imports inside
# functions run only then): the host tools, the lattice grammar and its
# device walk, a word graph and its n-best and confusion network, and
# the Toolbox's binary LM and grammar reads
LATTICE_CALLS = """
import contextlib, io, os, tempfile
import numpy as np, torch
from aaltoasr_tpu_torch import synth
from aaltoasr_tpu_torch.cli import (arpa2bin, bin2arpa, lattice_rescore,
                                    morph_lattice)
from aaltoasr_tpu_torch.decoder.ngram import lm_walk_device
from aaltoasr_tpu_torch.decoder.search import SearchConfig
from aaltoasr_tpu_torch.decoder.slf import SlfLattice, lattice_grammar
from aaltoasr_tpu_torch.decoder.toolbox import Toolbox
from aaltoasr_tpu_torch.decoder.wordgraph import WordGraph, confusion_network
from aaltoasr_tpu_torch.formats.model_io import write_model
ARPA = ("\\\\data\\\\\\nngram 1=4\\n\\n\\\\1-grams:\\n-0.5 <s>\\n"
        "-0.5 </s>\\n-0.3 au\\n-0.4 to\\n\\n\\\\end\\\\\\n")
SLF = ("VERSION=1.0\\nN=3 L=2\\nI=0 t=0\\nI=1 t=5\\nI=2 t=9\\n"
       "J=0 S=0 E=1 W=au a=-5.0 l=-1.0\\nJ=1 S=1 E=2 W=to a=-4.0 l=-1.0\\n")
d = tempfile.mkdtemp()
p = lambda n: os.path.join(d, n)
for n, text in (("lm.arpa", ARPA), ("in.slf", SLF), ("morphs", "au\\nto\\n"),
                ("text", "auto to\\n")):
    open(p(n), "w").write(text)
with contextlib.redirect_stdout(io.StringIO()):
    arpa2bin.main([p("lm.arpa"), p("lm.bin")])
    bin2arpa.main([p("lm.bin"), p("back.arpa")])
    lattice_rescore.main(["-l", p("lm.arpa"), "--mix", p("back.arpa"), "0.5",
                          "--best", p("in.slf")])
    morph_lattice.main(["--lm", p("lm.arpa"), "-w", "", p("in.slf")])
    morph_lattice.main(["--morphset", p("morphs"), p("text")])
g = lattice_grammar(SlfLattice.read(p("in.slf")))
nxt, sc = lm_walk_device(g.device_tables(), g.order, torch.tensor([0, 1]),
                         torch.tensor([0, 1]))
assert sc.tolist() == [0.0, 0.0]
wg = WordGraph.from_records(
    ["au", "to"], SearchConfig(), np.array([[0, -1], [1, -1]]),
    np.array([[-1, -1], [0, -1]]), np.array([[-5.0, 0], [-9.0, 0]]),
    np.zeros((2, 2)), 2, -9.5, 0.0)
assert wg.nbest(2)[0][0] == ["au", "to"] and confusion_network(wg)
wg.write_slf(p("wg.slf"))
write_model(p("m"), synth.random_model(G=4, S=2, D=3, K=1))
t = Toolbox(p("m.ph"), device="cpu")
t.ngram_read(p("lm.bin"), binary=True)
t.htk_lattice_grammar_read(p("wg.slf"))
assert t.lm.vocab == ["au", "to"]
"""

# the streaming slice's entry points: decode_stream on a raw file, and a
# Toolbox with an interpolated LM, word classes, context lookahead and
# the pruning beams, pushed frame by frame
STREAM_CALLS = """
from aaltoasr_tpu_torch.cli import decode_stream
open(p("f.cfg"), "w").write(synth.mfcc_cfg())
write_model(p("s"), synth.random_model(G=16, S=8, D=39, K=2))
open(p("s.lex"), "w").write("au p0 p1\\nto p2 p3\\n")
open(p("cls"), "w").write("au 1.0 au\\nto 0.5 to\\n")
(np.random.default_rng(0).normal(0, 300, 8000).astype("<i2")
 .tofile(p("a.raw")))
with contextlib.redirect_stdout(io.StringIO()), \\
        contextlib.redirect_stderr(io.StringIO()):
    decode_stream.main(["-b", p("s"), "-c", p("f.cfg"), "-l", p("s.lex"),
                        "-n", p("lm.arpa"), "--tokens", "32",
                        "--partial-every", "16", "--device", "cpu",
                        p("a.raw")])
lp = np.log(np.full((6, 8), 1 / 8, np.float32))
for lm_call, la in (("interpolated_ngram_read", 2), ("ngram_read", 3)):
    t = Toolbox(p("s.ph"), device="cpu")
    t.set_token_limit(32)
    t.set_eq_word_count_beam(50.0)
    t.set_tp_state_beam(50.0)
    t.lex_read(p("s.lex"))
    if la == 2:
        t.interpolated_ngram_read([p("lm.arpa"), p("back.arpa")], [0.5, 0.5])
        t.read_word_classes(p("cls"))
    else:
        t.ngram_read(p("lm.arpa"))
    t.set_lm_lookahead(la)
    sd = t.use_one_frame_acoustics()
    sd.push_frames(lp)
    sd.partial()
    t.stream_result()
"""

TRAIN_CALLS = """
from aaltoasr_tpu_torch.cli import (align, combine_stats, dur_est, estimate,
                                    gcluster, logl, stats, train)
write_model(p("tm"), synth.random_model(G=16, S=8, D=39, K=2))
synth.write_wav(p("t.wav"),
                np.random.default_rng(1).normal(0, 300, 8000).astype("<i2"))
open(p("t.phn"), "w").write("p0\\np1\\np2\\n")
open(p("t.rcp"), "w").write(
    f"audio={p('t.wav')} transcript={p('t.phn')} alignment={p('t.ali')}\\n")
open(p("st.lst"), "w").write(p("st") + "\\n")
m = ["-b", p("tm"), "-c", p("f.cfg"), "-r", p("t.rcp")]
with contextlib.redirect_stdout(io.StringIO()), \\
        contextlib.redirect_stderr(io.StringIO()):
    align.main(m + ["--device", "cpu"])
    stats.main(m + ["-o", p("st"), "--device", "cpu"])
    combine_stats.main(["-b", p("tm"), "-L", p("st.lst"), "-o", p("st2")])
    estimate.main(["-b", p("tm"), "-L", p("st.lst"), "-o", p("tm2"), "--ml"])
    logl.main(m + ["--device", "cpu"])
    dur_est.main(["-b", p("tm"), "-r", p("t.rcp"), "-O", "-o", p("t.dur")])
    gcluster.main(["-b", p("tm"), "-C", "4", "-o", p("t.gcl")])
    train.main(m + ["-w", p("w"), "--num-iters", "1", "--mllt-start-iter",
                    "0", "--device", "cpu", "-i", "0"])
assert os.path.exists(p("w/model_1.ph"))
"""

DISCRIM_CALLS = """
from aaltoasr_tpu_torch.cli import make_hmmnets, train_ebw
open(p("h.rcp"), "w").write(
    f"audio={p('t.wav')} transcript={p('t.phn')} hmmnet={p('t.num')} "
    f"den-hmmnet={p('t.num')}\\n")
h = ["-b", p("tm"), "-c", p("f.cfg"), "-r", p("h.rcp"), "--device", "cpu"]
with contextlib.redirect_stdout(io.StringIO()), \\
        contextlib.redirect_stderr(io.StringIO()):
    make_hmmnets.main(h)
    stats.main(h + ["-o", p("hs"), "-H", "--mmi", "--mpe", "--errmode",
                    "mpfe-pdf"])
    stats.main(h + ["-o", p("hv"), "-H", "-M", "mpv"])
    train_ebw.main(h + ["-w", p("we"), "--num-iters", "1",
                        "--criterion", "mpe"])
assert os.path.exists(p("we/ebw_1.ph"))
"""


def test_port_imports_no_jax():
    """Every module of the port (and chip_smoke.py) imports without
    pulling jax or the JAX package into the process, nor does a call of
    each lattice, streaming, training and discriminative-training entry
    point."""
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import aaltoasr_tpu_torch as P\n"
        "names = [m.name for m in pkgutil.walk_packages(P.__path__, "
        "'aaltoasr_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n" + LATTICE_CALLS + STREAM_CALLS + TRAIN_CALLS
        + DISCRIM_CALLS +
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'aaltoasr_tpu' or m.startswith('aaltoasr_tpu.')]\n"
        "print(json.dumps({'modules': names, 'bad': bad}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    for m in ("decoder.search_dense", "decoder.wordgraph", "decoder.slf",
              "decoder.intergram", "decoder.morpheus", "decoder.morphset",
              "formats.treegram_bin", "cli.lattice_rescore",
              "cli.morph_lattice", "cli.arpa2bin", "cli.bin2arpa",
              "decoder.classes", "cli.decode_stream", "ops.chain",
              "models.hmm", "formats.phn", "train.estep", "train.driver",
              "train.accumulators", "train.estimate", "train.split",
              "train.ebw", "train.durations", "train.gcluster",
              "train.mllt", "cli.align", "cli.stats", "cli.estimate",
              "cli.train", "cli.combine_stats", "cli.logl", "cli.dur_est",
              "cli.gcluster", "formats.fst", "models.hmmnet", "train.mpe",
              "train.opt_ebw_d", "decoder.stateseg", "cli.make_hmmnets",
              "cli.train_ebw", "cli.opt_ebw_d"):
        assert "aaltoasr_tpu_torch." + m in res["modules"]
    assert len(res["modules"]) >= 35
