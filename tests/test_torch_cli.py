"""PyTorch port, CLIs: `phone_probs`, `recognize` (both engines, with
lattices, n-best lists and confidences), `decode` (with an n-gram or a
lattice grammar) and the host SLF and LM tools on the recognize-CLI test
task, against the JAX package's CLIs (CPU; the port's CLIs get
``--device cpu``, since they default to the GPU); and the device and
refusal rules of every entry point, the training CLIs' included (their
parity tests are `tests/test_torch_train_cli.py`)."""

import inspect
import re
import shutil

import numpy as np
import pytest
import torch

from aaltoasr_tpu.cli import arpa2bin as j_arpa2bin
from aaltoasr_tpu.cli import bin2arpa as j_bin2arpa
from aaltoasr_tpu.cli import lattice_rescore as j_lattice_rescore
from aaltoasr_tpu.cli import morph_lattice as j_morph_lattice
from aaltoasr_tpu.cli.decode import main as j_decode
from aaltoasr_tpu.cli.phone_probs import main as j_phone_probs
from aaltoasr_tpu.cli.recognize import main as j_recognize
from aaltoasr_tpu.decoder.search import BeamSearch as JBeamSearch
from aaltoasr_tpu.decoder.search import SearchConfig as JConfig
from aaltoasr_tpu.formats.lna import read_lna

from aaltoasr_tpu_torch.cli import arpa2bin as t_arpa2bin
from aaltoasr_tpu_torch.cli import bin2arpa as t_bin2arpa
from aaltoasr_tpu_torch.cli import lattice_rescore as t_lattice_rescore
from aaltoasr_tpu_torch.cli import morph_lattice as t_morph_lattice
from aaltoasr_tpu_torch.cli.decode import main as t_decode
from aaltoasr_tpu_torch.cli.phone_probs import main as t_phone_probs
from aaltoasr_tpu_torch.cli.recognize import main as t_recognize
from aaltoasr_tpu_torch.cli.recognize import morph_text
from aaltoasr_tpu_torch.decoder.search import BeamSearch
from aaltoasr_tpu_torch.decoder.search_dense import DenseBeamSearch
from aaltoasr_tpu_torch.decoder.toolbox import Toolbox
from aaltoasr_tpu_torch.frontend.generator import FeatureGenerator
from aaltoasr_tpu_torch.models.phone_probs import PhoneProbs
from aaltoasr_tpu_torch.ops.gmm import GmmScorer
from aaltoasr_tpu_torch.parallel.distributed import global_mesh
from aaltoasr_tpu_torch.parallel.mesh import make_mesh, sharded_train_step
from aaltoasr_tpu_torch.train.driver import EStepDriver
from __graft_entry_torch__ import entry as graft_entry

from tests.test_decoder import ARPA_TEXT, make_decode_task, synth_obs
from tests.test_golden_morph_lattice import MORPHS, TEXTS
from tests.test_recognize_cli import _task
from tests.test_torch_lattice import BOOSTED, assert_same_slf

# the tests run tiny tensors in several worker processes at once: one
# intra-op thread each avoids oversubscribing the cores
torch.set_num_threads(1)


def _args(tmp_path, recipe, work):
    return ["-b", str(tmp_path / "am"), "-c", str(tmp_path / "feats.cfg"),
            "-l", str(tmp_path / "lex.txt"), "-n", str(tmp_path / "lm.arpa"),
            "-r", str(recipe), "-w", str(tmp_path / work),
            "--lm-scale", "2", "--duration-scale", "0"]


def _port_args(tmp_path, recipe, work):
    return _args(tmp_path, recipe, work) + ["--device", "cpu"]


def _lines(capsys, main, argv):
    assert main(argv) in (0, None)
    return [ln for ln in capsys.readouterr().out.splitlines()
            if ln.endswith(")")]


def _codes(path):
    lp, nbytes = read_lna(str(path))
    assert nbytes == 2
    return np.round(-1820.0 * lp.astype(np.float64)).astype(np.int64)


@pytest.mark.parametrize("fused", [False, True])
def test_phone_probs_lnas_match_reference(tmp_path, fused):
    """2-byte LNA codes within one step of the reference's, >= 99%
    identical (XLA and torch sum in different orders)."""
    recipe = _task(tmp_path)
    for main, out in ((j_phone_probs, "ref"), (t_phone_probs, "port")):
        (tmp_path / out).mkdir()
        argv = ["-b", str(tmp_path / "am"), "-c", str(tmp_path / "feats.cfg"),
                "-r", str(recipe), "-o", str(tmp_path / out)]
        if out == "port":
            argv += ["--device", "cpu"] + (["--fused"] if fused else [])
        assert main(argv) == 0
    diffs = []
    for u in range(3):
        ref = _codes(tmp_path / "ref" / f"u{u}.wav.lna")
        got = _codes(tmp_path / "port" / f"u{u}.wav.lna")
        assert got.shape == ref.shape
        diffs.append(np.abs(got - ref).ravel())
    diff = np.concatenate(diffs)
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99


def test_recognize_dense_matches_reference(tmp_path, capsys):
    recipe = _task(tmp_path)
    dense = ["--engine", "dense", "--decode-batch", "2"]
    ref = _lines(capsys, j_recognize, _args(tmp_path, recipe, "ref") + dense)
    got = _lines(capsys, t_recognize,
                 _port_args(tmp_path, recipe, "port") + dense)
    assert len(ref) == 3 and got == ref


def test_fused_phone_probs_then_recognize(tmp_path, capsys):
    """rectool's two-stage flow: LNAs from `phone_probs --fused`, then
    `recognize` reuses them (skip-if-exists)."""
    recipe = _task(tmp_path)
    (tmp_path / "port" / "lna").mkdir(parents=True)
    assert t_phone_probs(["-b", str(tmp_path / "am"),
                          "-c", str(tmp_path / "feats.cfg"),
                          "-r", str(recipe), "--fused", "--device", "cpu",
                          "-o", str(tmp_path / "port" / "lna")]) == 0
    dense = ["--engine", "dense"]
    ref = _lines(capsys, j_recognize, _args(tmp_path, recipe, "ref") + dense)
    got = _lines(capsys, t_recognize,
                 _port_args(tmp_path, recipe, "port") + dense)
    assert got == ref


def test_morph_lm(tmp_path, capsys):
    recipe = _task(tmp_path)
    (tmp_path / "lex.txt").write_text("aa a a\n<w> _\n")
    (tmp_path / "lm.arpa").write_text(
        "\\data\\\nngram 1=4\nngram 2=3\n\n\\1-grams:\n"
        "-0.5 <s> -0.3\n-0.5 </s> -0.3\n-0.5 aa -0.3\n-0.5 <w> -0.3\n"
        "\n\\2-grams:\n-0.3 <s> aa\n-0.3 aa <w>\n-0.3 <w> </s>\n\n\\end\\\n")
    dense = ["--engine", "dense"]
    ref = _lines(capsys, j_recognize, _args(tmp_path, recipe, "ref") + dense)
    got = _lines(capsys, t_recognize,
                 _port_args(tmp_path, recipe, "port") + dense)
    assert len(ref) == 3 and got == ref
    # and at the default engine (exact on this task)
    ref = _lines(capsys, j_recognize, _args(tmp_path, recipe, "ref"))
    got = _lines(capsys, t_recognize, _port_args(tmp_path, recipe, "port"))
    assert len(ref) == 3 and got == ref


def emitted_morph_text(words):
    """`recognize`'s printed text of a morph LM's units before
    `morph_text` was factored out of its `emit` (rectool.py:1025-1037)."""
    text = " ".join(words)
    text = text.replace(" ", "")
    text = text.replace("<w></s><s><w>", " ")
    text = text.replace("<w>", " ")
    text = text.replace("<s>", "").replace("</s>", "")
    return " ".join(text.split())


@pytest.mark.parametrize("words", [
    [], ["aa"], ["<w>", "aa", "<w>"], ["aa", "<w>", "aa", "bb", "<w>"],
    ["<s>", "<w>", "aa", "<w>", "</s>", "<s>", "<w>", "bb", "<w>", "</s>"],
    ["aa", "</s>", "<s>", "<w>", "bb"], ["aa", "bb", "</s>"]])
def test_morph_text_is_what_recognize_printed(words):
    assert morph_text(words) == emitted_morph_text(words)


def test_recognize_defaults_match_reference(tmp_path, capsys):
    """No --engine flag: auto picks the exact engine on this task, with
    every knob at its default (W=1024, E=128)."""
    recipe = _task(tmp_path)
    ref = _lines(capsys, j_recognize, _args(tmp_path, recipe, "ref"))
    assert t_recognize(_port_args(tmp_path, recipe, "port")) == 0
    cap = capsys.readouterr()
    got = [ln for ln in cap.out.splitlines() if ln.endswith(")")]
    assert len(ref) == 3 and got == ref
    assert "-> exact" in cap.err


# the bench's exact cross-word operating point (bench.py:150-153)
BENCH_KNOBS = ["--tokens", "512", "--overflow-tokens", "128",
               "--we-prewalk", "256", "--reentry-records", "8",
               "--reentry-prewalk", "8"]


@pytest.mark.parametrize("extra", [
    BENCH_KNOBS, ["--word-end-beam", "40", "--lookahead", "1"],
    ["--lookahead", "2", "--no-require-end"]])
def test_recognize_exact_matches_reference(tmp_path, capsys, extra):
    recipe = _task(tmp_path)
    exact = ["--engine", "exact"] + extra
    ref = _lines(capsys, j_recognize, _args(tmp_path, recipe, "ref") + exact)
    got = _lines(capsys, t_recognize,
                 _port_args(tmp_path, recipe, "port") + exact)
    assert len(ref) == 3 and got == ref


def test_decode_matches_reference(tmp_path, capsys):
    """`decode` on LNAs written by the reference's `phone_probs`, with a
    duration file and unigram lookahead from a separate LM."""
    from aaltoasr_tpu.formats import model_io
    from tests.test_train import three_state_model
    recipe = _task(tmp_path)
    (tmp_path / "lna").mkdir()
    assert j_phone_probs(["-b", str(tmp_path / "am"),
                          "-c", str(tmp_path / "feats.cfg"), "-r", str(recipe),
                          "-o", str(tmp_path / "lna")]) == 0
    rng = np.random.default_rng(3)
    S = three_state_model(seed=5, D=4).num_states
    model_io.write_dur(str(tmp_path / "am.dur"), np.stack(
        [rng.uniform(1.5, 3.0, S), rng.uniform(1.0, 2.0, S)], axis=1))
    lna_recipe = tmp_path / "lna.recipe"
    lna_recipe.write_text("".join(
        f"lna={tmp_path / 'lna' / f'u{u}.wav.lna'} utterance=u{u}\n"
        for u in range(3)))
    argv = ["-p", str(tmp_path / "am.ph"), "-d", str(tmp_path / "am.dur"),
            "-l", str(tmp_path / "lex.txt"), "-n", str(tmp_path / "lm.arpa"),
            "-r", str(lna_recipe), "--lm-scale", "2", "--lookahead", "1",
            "--lookahead-ngram", str(tmp_path / "lm.arpa")]
    ref = _lines(capsys, j_decode, argv)
    got = _lines(capsys, t_decode, argv + ["--device", "cpu"])
    assert len(ref) == 3 and got == ref


# recognize's lattice output: the 1-best line, "  i: words (score)" per
# n-best entry and "  conf: word(c) ..." (rectool's layout)
NBEST = re.compile(r"^  (\d+): (.*) \((-?[\d.]+)\)$")


def _lattice_output(text):
    """(1-best lines, n-best [(rank, words, score)], confidences [[(word,
    c)]]) of recognize's stdout."""
    best, nbest, conf = [], [], []
    for ln in text.splitlines():
        m = NBEST.match(ln)
        if m:
            nbest.append((int(m[1]), m[2], float(m[3])))
        elif ln.startswith("  conf: "):
            conf.append([(w, float(c)) for w, c in
                         re.findall(r"(\S+)\(([\d.]+)\)", ln[8:])])
        elif ln.endswith(")"):
            best.append(ln)
    return best, nbest, conf


@pytest.mark.parametrize("engine", ["exact", "dense"])
def test_recognize_lattices_match_reference(tmp_path, capsys, engine):
    """`--lattices --nbest 3 --confidence`: the 1-best lines identical,
    the n-best words identical and their scores within one printed step
    (1e-3) plus rtol 1e-5, the confidences within one printed step
    (0.01), and each `<lna>.slf` the reference's (node frames and arc
    keys identical, arc scores within atol 2e-3)."""
    recipe = _task(tmp_path)
    extra = ["--engine", engine, "--lattices", "--nbest", "3",
             "--confidence"]
    out = {}
    for side, main, argv in (
            ("ref", j_recognize, _args(tmp_path, recipe, "ref")),
            ("port", t_recognize, _port_args(tmp_path, recipe, "port"))):
        assert main(argv + extra) in (0, None)
        out[side] = _lattice_output(capsys.readouterr().out)
    (rb, rn, rc), (gb, gn, gc) = out["ref"], out["port"]
    assert len(rb) == 3 and gb == rb
    assert len(rn) >= 3 and [x[:2] for x in gn] == [x[:2] for x in rn]
    for (_, _, r), (_, _, g) in zip(rn, gn):
        assert abs(g - r) <= 1e-3 + 1e-5 * abs(r)
    assert len(rc) == 3 and [[w for w, _ in c] for c in gc] == [
        [w for w, _ in c] for c in rc]
    for r, g in zip(rc, gc):
        np.testing.assert_allclose([c for _, c in g], [c for _, c in r],
                                   rtol=0, atol=0.01 + 1e-9)
    for u in range(3):
        name = f"u{u}.wav.lna.slf"
        assert_same_slf((tmp_path / "ref" / "lna" / name).read_text(),
                        (tmp_path / "port" / "lna" / name).read_text())


def test_decode_lattice_grammar_raises(tmp_path, capsys):
    """`decode` exits without -n or --lattice-grammar; with a lattice of
    the reference's `recognize --lattices` as the grammar it prints the
    reference's lines."""
    with pytest.raises(SystemExit):
        t_decode(["-p", "m.ph", "-l", "lex", "-r", "recipe", "--device",
                  "cpu"])
    recipe = _task(tmp_path)
    assert j_recognize(_args(tmp_path, recipe, "ref")
                       + ["--engine", "dense", "--lattices"]) == 0
    capsys.readouterr()
    lna = tmp_path / "ref" / "lna"
    lna_recipe = tmp_path / "lna.recipe"
    lna_recipe.write_text("".join(
        f"lna={lna / f'u{u}.wav.lna'} utterance=u{u}\n" for u in range(3)))
    argv = ["-p", str(tmp_path / "am.ph"), "-l", str(tmp_path / "lex.txt"),
            "-r", str(lna_recipe), "--lm-scale", "2",
            "--duration-scale", "0",
            "--lattice-grammar", str(lna / "u0.wav.lna.slf")]
    ref = _lines(capsys, j_decode, argv)
    got = _lines(capsys, t_decode, argv + ["--device", "cpu"])
    assert len(ref) == 3 and got == ref


MORPH_ARPA = ("\\data\\\nngram 1=7\n\n\\1-grams:\n"
              "-0.5 <s>\n-0.5 </s>\n-0.5 <w>\n"
              "-0.5 au\n-0.9 to\n-0.5 ta\n-0.9 lo\n\n\\end\\\n")
MORPH_SLF = ("VERSION=1.0\nlmscale=30.0 wdpenalty=0.0\nN=3 L=3\n"
             "I=0 t=0\nI=1 t=10\nI=2 t=20\n"
             "J=0 S=0 E=1 W=auto a=-100.0 l=-1.0\n"
             "J=1 S=1 E=2 W=talo a=-120.0 l=-2.0\n"
             "J=2 S=0 E=2 W=xyz a=-300.0 l=-4.0\n")

# each tool's arguments, relative to the test's directory; outputs go to
# "out" (or stdout)
TOOLS = {
    "lattice_rescore": ["-l", "lm.arpa", "-o", "out", "in.slf"],
    "lattice_rescore_stdout_lm_scale": ["-l", "lm.arpa", "--lm-scale", "4",
                                        "in.slf"],
    "lattice_rescore_best_boosted": ["-l", "boosted.arpa", "--best",
                                     "in.slf"],
    "lattice_rescore_mix": ["-l", "lm.arpa", "--mix", "boosted.arpa", "0.3",
                            "--best", "-o", "out", "in.slf"],
    "lattice_rescore_binary": ["-b", "-l", "lm.bin", "-o", "out", "in.slf"],
    "morph_lattice_lm": ["--lm", "morph.arpa", "-o", "out", "morph.slf"],
    "morph_lattice_lm_no_boundary": ["--lm", "morph.arpa", "-w", "",
                                     "morph.slf"],
    "morph_lattice_morphset": ["--morphset", "morphs", "-o", "out",
                               "corpus.txt"],
    "arpa2bin": ["boosted.arpa", "out"],
    "arpa2bin_interpolated": ["-i", "lm.arpa", "out"],
    "bin2arpa": ["lm.bin", "out"],
}


@pytest.mark.parametrize("tool", list(TOOLS))
def test_lattice_tools_match_reference(tmp_path, capsys, monkeypatch, tool):
    """The host tools on the same files write the reference's bytes."""
    model, tree, fsa = make_decode_task()
    res = JBeamSearch(tree, fsa, model, JConfig(
        num_tokens=64, num_records=8, beam=1e9, lm_scale=1.0)).decode(
            synth_obs(tree, model, ["_", "a", "b", "b", "a", "_"],
                      noise=1.0, seed=4))
    res.word_graph().write_slf(str(tmp_path / "in.slf"))
    (tmp_path / "lm.arpa").write_text(ARPA_TEXT)
    (tmp_path / "boosted.arpa").write_text(BOOSTED)
    (tmp_path / "morph.arpa").write_text(MORPH_ARPA)
    (tmp_path / "morph.slf").write_text(MORPH_SLF)
    (tmp_path / "morphs").write_text("\n".join(MORPHS) + "\n")
    (tmp_path / "corpus.txt").write_text("".join(TEXTS))
    assert j_arpa2bin.main([str(tmp_path / "lm.arpa"),
                            str(tmp_path / "lm.bin")]) == 0
    monkeypatch.chdir(tmp_path)
    name = next(n for n in ("lattice_rescore", "morph_lattice", "arpa2bin",
                            "bin2arpa") if tool.startswith(n))
    outputs = []
    for mod in {"lattice_rescore": (j_lattice_rescore, t_lattice_rescore),
                "morph_lattice": (j_morph_lattice, t_morph_lattice),
                "arpa2bin": (j_arpa2bin, t_arpa2bin),
                "bin2arpa": (j_bin2arpa, t_bin2arpa)}[name]:
        assert mod.main(TOOLS[tool]) in (0, None)
        out = tmp_path / "out"
        outputs.append((capsys.readouterr().out,
                        out.read_bytes() if out.exists() else None))
        if out.exists():
            out.unlink()
    assert outputs[1] == outputs[0]
    assert outputs[0][0] or outputs[0][1]


@pytest.mark.parametrize("extra,match", [
    (["--engine", "exact", "--stateseg"], None),   # state segmentation
    (["--lookahead", "3"], None),        # context lookahead: now ported
    (["--engine", "dense", "--stateseg"], None),
    # adaptation (ROADMAP item 6): now ported, each mode
    (["--engine", "dense", "--adapt", "vtln"], None),
    (["--engine", "dense", "--adapt", "mllr"], None),
    (["--engine", "dense", "--adapt", "vtln+mllr"], None),
    (["--engine", "dense", "--adapt", "cmllr"], None),
    # the training CLIs (first element): the hmmnet half of item 5, now
    # ported
    (["stats", "-H"], None),
    (["stats", "--mmi", "-H"], None),
    (["stats", "--mpe", "-H"], None),
    (["stats", "-M", "mpv", "-H"], None),
    (["train", "-H"], None),
    (["logl", "-H"], None),
])
def test_unported_options_raise(tmp_path, capsys, monkeypatch, extra, match):
    """Options still to port raise naming their ROADMAP item; a ported
    one (match None) gives the reference's results: `recognize` its
    lines (and with --stateseg its .stateseg files, byte for byte), the
    training CLIs on the task's hmmnet= and den-hmmnet= networks and the
    reference's features their statistics (within
    `tests/test_torch_discrim.py`'s tolerances; --mpe's segment mode with
    the reference's dead-arc weights, as there), models (rtol 2e-3) and
    log-likelihoods (rel 1e-5); with --adapt, on a two-speaker task,
    its lines, its .spkc files and its LNAs (`_adapt_parity`)."""
    if "--adapt" in extra:
        _adapt_parity(tmp_path, capsys, monkeypatch, extra)
        return
    recipe = _task(tmp_path)
    if extra[0] in TRAINING_CLIS:
        _training_parity(tmp_path, capsys, monkeypatch, recipe, extra)
        return
    if match is None:
        ref = _lines(capsys, j_recognize,
                     _args(tmp_path, recipe, "ref") + extra)
        got = _lines(capsys, t_recognize,
                     _port_args(tmp_path, recipe, "port") + extra)
        assert len(ref) == 3 and got == ref
        segs = sorted((tmp_path / "ref" / "lna").glob("*.stateseg"))
        assert len(segs) == (3 if "--stateseg" in extra else 0)
        for want in segs:
            assert (tmp_path / "port" / "lna" / want.name).read_bytes() == \
                want.read_bytes()
        return
    with pytest.raises(NotImplementedError, match=match):
        t_recognize(_port_args(tmp_path, recipe, "port") + extra)


def _adapt_task(tmp_path, samples=66000, **corpus):
    """`tests/test_torch_adapt_cli.adapt_corpus` (by default with 1,000+
    frames per speaker, so that MLLR passes its 1,000-frame gate), the
    lexicon and LM of `tests/test_recognize_cli.py`'s task; returns
    recognize's arguments but the workdir."""
    from tests.test_torch_adapt_cli import adapt_corpus
    recipe = adapt_corpus(tmp_path, samples=samples, **corpus)
    (tmp_path / "lm").mkdir()
    _task(tmp_path / "lm")
    return ["-b", str(tmp_path / "am"), "-c", str(tmp_path / "adapt.cfg"),
            "-l", str(tmp_path / "lm" / "lex.txt"),
            "-n", str(tmp_path / "lm" / "lm.arpa"), "-r", str(recipe),
            "--lm-scale", "2", "--duration-scale", "0"]


def _lna_codes_close(ref_dir, port_dir):
    """LNA codes of the same names within one step, >= 99% identical."""
    names = sorted(p.name for p in ref_dir.glob("*.lna"))
    assert names == sorted(p.name for p in port_dir.glob("*.lna"))
    diff = np.concatenate([np.abs(_codes(port_dir / n) - _codes(ref_dir / n))
                           .ravel() for n in names])
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99
    return names


def use_reference_frontend(monkeypatch):
    """The port's `FeatureGenerator.features` returns the reference
    generator's features for the same configuration, samples and
    runtime parameters (the speaker's warp or transform), so LNA
    generation compares the speaker handling and the scoring alone."""
    from aaltoasr_tpu.formats.feaconf import FeatureConfig as JConfig
    from aaltoasr_tpu.frontend.generator import FeatureGenerator as JGen
    gens = {}

    def features(self, samples, num_samples=None):
        text = self.config.dump()
        gen = gens.setdefault(text, JGen(JConfig.parse(text)))
        gen.params = {name: {k: v.cpu().numpy() for k, v in p.items()}
                      for name, p in self._dev_params.items()}
        return torch.as_tensor(np.array(gen.features(
            np.asarray(samples), num_samples)), device=self.device)

    monkeypatch.setattr(FeatureGenerator, "features", features)


def _adapt_parity(tmp_path, capsys, monkeypatch, extra):
    """`recognize --adapt MODE` of the port against the reference's on a
    two-speaker task: the same lines; the same warps and transforms
    within 1e-3 of their scale in every .spkc it writes; model-space
    CMLLR rebuilt once per speaker, not per utterance.  Then the port
    runs again on the reference's .spkc (reused from the workdir, as
    rectool does) with the reference's frontend numbers: the same lines,
    and LNA codes within one step, >= 99% identical.  The LNAs of the
    first runs are not compared: each package's own transforms
    differ by ~1e-4 of their scale (float32 forward-backward
    statistics), and transforms with entries of 5-12, as this task
    estimates, scale the frontends' ~1e-5 differences with them."""
    from aaltoasr_tpu_torch.train import mllr as t_mllr
    from tests.test_torch_adapt_cli import _spkc_close
    argv = _adapt_task(tmp_path) + extra
    builds = []
    rebuild = t_mllr.apply_model_cmllr
    monkeypatch.setattr(t_mllr, "apply_model_cmllr",
                        lambda *a: builds.append(1) or rebuild(*a))
    ref = _lines(capsys, j_recognize, argv + ["-w", str(tmp_path / "ref")])
    got = _lines(capsys, t_recognize, argv + ["-w", str(tmp_path / "port"),
                                              "--device", "cpu"])
    assert len(ref) == 4 and got == ref
    mode = extra[-1]
    spkcs = [f"{mode}.spkc"] + (["vtln.spkc"] if mode == "vtln+mllr" else [])
    for name in spkcs:
        _spkc_close(tmp_path / "ref" / name, tmp_path / "port" / name,
                    atol=1e-3)
    assert len(builds) == (2 if mode == "cmllr" else 0)
    (tmp_path / "same").mkdir()
    for name in spkcs:
        shutil.copy(tmp_path / "ref" / name, tmp_path / "same" / name)
    use_reference_frontend(monkeypatch)
    again = _lines(capsys, t_recognize, argv + ["-w", str(tmp_path / "same"),
                                                "--device", "cpu"])
    assert again == ref
    _lna_codes_close(tmp_path / "ref" / "lna", tmp_path / "same" / "lna")


def test_recognize_adapt_sets_each_speaker(tmp_path, capsys):
    """With two speakers, `recognize --adapt vtln` sets each speaker's
    warp before its utterances: each LNA differs from the unadapted
    one exactly where the reference's does (a speaker at warp 1.0 keeps
    its codes), and matches the reference's within one step."""
    from aaltoasr_tpu.formats.spkc import SpeakerConfig
    argv = _adapt_task(tmp_path) + ["--engine", "dense"]
    for main, tag in ((j_recognize, "ref"), (t_recognize, "port")):
        dev = ["--device", "cpu"] if tag == "port" else []
        for mode in ("", "vtln"):
            work = tmp_path / f"{tag}{mode}"
            _lines(capsys, main, argv + ["-w", str(work), "--adapt", mode]
                   + dev)
    warps = {spk: blocks[("feature", "vtln")].get_float("warp_factor")
             for spk, blocks in SpeakerConfig.load(
                 str(tmp_path / "refvtln" / "vtln.spkc")).speakers.items()}
    assert any(w != 1.0 for w in warps.values()), warps
    names = _lna_codes_close(tmp_path / "refvtln" / "lna",
                             tmp_path / "portvtln" / "lna")
    for n in names:
        moved = {tag: not np.array_equal(
            _codes(tmp_path / f"{tag}vtln" / "lna" / n),
            _codes(tmp_path / tag / "lna" / n)) for tag in ("ref", "port")}
        assert moved["port"] == moved["ref"] == (
            warps[n.split("_")[0] + "_" + n.split("_")[1]] != 1.0), n


def test_recognize_adapt_utterance_ids_raise_as_reference(tmp_path,
                                                          capsys):
    """A recipe with utterance ids and a .spkc with no utterance blocks
    (what `vtln` and `mllr` write): both packages' `set_utterance`
    raise KeyError once adaptation is estimated (ROADMAP Queue 3)."""
    argv = _adapt_task(tmp_path, samples=6000, utterance_ids=True) + [
        "--engine", "dense", "--adapt", "vtln"]
    for main, tag in ((j_recognize, "ref"), (t_recognize, "port")):
        dev = ["--device", "cpu"] if tag == "port" else []
        with pytest.raises(KeyError, match="unknown utterance"):
            main(argv + ["-w", str(tmp_path / tag)] + dev)
        assert (tmp_path / tag / "vtln.spkc").exists()


def _training_parity(tmp_path, capsys, monkeypatch, recipe, extra):
    """A training CLI of the port against the reference's on the task
    with a numerator and a denominator network per utterance."""
    import importlib
    from aaltoasr_tpu.formats import model_io as j_mio
    from aaltoasr_tpu.formats.fst import write_fst
    from aaltoasr_tpu.models.hmm import TransitionTable
    from aaltoasr_tpu.models.hmmnet import transcript_hmmnet, union_fst
    from aaltoasr_tpu.train import accumulators as j_acc
    from tests.test_golden_estimate import assert_models_close
    from tests.test_torch_discrim import stats_close_all
    from tests.test_torch_train_cli import use_reference_features
    from aaltoasr_tpu_torch.train import mpe as t_mpe
    use_reference_features(monkeypatch)
    monkeypatch.setattr(t_mpe, "_live_w", t_mpe._exp_w)
    model = j_mio.read_model(str(tmp_path / "am"))
    table = TransitionTable.from_model(model)
    lines = recipe.read_text().splitlines()
    seqs = [(tmp_path / f"u{u}.phn").read_text().split()
            for u in range(len(lines))]
    for u, seq in enumerate(seqs):
        write_fst(transcript_hmmnet(model, table, seq),
                  str(tmp_path / f"u{u}.num"))
        write_fst(union_fst(transcript_hmmnet(model, table, seq),
                            transcript_hmmnet(model, table, seqs[u - 1])),
                  str(tmp_path / f"u{u}.den"))
        lines[u] += (f" hmmnet={tmp_path}/u{u}.num "
                     f"den-hmmnet={tmp_path}/u{u}.den")
    recipe.write_text("\n".join(lines) + "\n")
    cli = extra[0]
    outs = []
    for side, pkg, dev in (("ref", "aaltoasr_tpu", []),
                           ("port", "aaltoasr_tpu_torch", ["--device",
                                                           "cpu"])):
        main = importlib.import_module(f"{pkg}.cli.{cli}").main
        argv = ["-b", str(tmp_path / "am"), "-c", str(tmp_path / "feats.cfg"),
                "-r", str(recipe)] + extra[1:]
        argv += {"stats": ["-o", str(tmp_path / side)],
                 "train": ["-w", str(tmp_path / side), "--num-iters", "1",
                           "--mllt-start-iter", "0", "--split-frequency",
                           "0", "-i", "0"]}.get(cli, [])
        (tmp_path / side).mkdir(exist_ok=True)
        assert main(argv + dev) in (0, None)
        outs.append(capsys.readouterr().out)
    if cli == "stats":
        mode = j_acc.PDF_ML_STATS
        if "--mmi" in extra:
            mode |= j_acc.PDF_MMI_STATS
        if "--mpe" in extra:
            mode |= j_acc.PDF_MPE_NUM_STATS | j_acc.PDF_MPE_DEN_STATS
        loaded = []
        for side in ("port", "ref"):
            st = j_acc.HmmStats.zeros(model, table, mode)
            st.load(str(tmp_path / side), table)
            loaded.append(st)
        stats_close_all(*loaded)
    elif cli == "train":
        assert_models_close(
            j_mio.read_model(str(tmp_path / "ref" / "model_1")),
            j_mio.read_model(str(tmp_path / "port" / "model_1")), rtol=2e-3)
    else:
        (ll_r, n_r), (ll_p, n_p) = (o.split() for o in outs)
        assert n_p == n_r
        assert float(ll_p) == pytest.approx(float(ll_r), rel=1e-5)


TRAINING_CLIS = ("stats", "align", "train", "logl", "make_hmmnets",
                 "train_ebw")


def _training_cli(tmp_path, recipe, cli):
    """(main, argv) of a training CLI of the port on the task's files."""
    import importlib
    main = importlib.import_module(f"aaltoasr_tpu_torch.cli.{cli}").main
    argv = ["-b", str(tmp_path / "am"), "-c", str(tmp_path / "feats.cfg"),
            "-r", str(recipe)]
    extra = {"stats": ["-o", str(tmp_path / "port" / "st")],
             "train": ["-w", str(tmp_path / "port" / "work")],
             "train_ebw": ["-w", str(tmp_path / "port" / "work")]}
    return main, argv + extra.get(cli, [])


@pytest.mark.parametrize("cli", ["phone_probs", "recognize"]
                         + list(TRAINING_CLIS))
def test_cli_without_device_raises_with_no_gpu(tmp_path, monkeypatch, cli):
    """With no GPU and no --device the CLIs raise; they never fall back
    to the CPU on their own (and run with --device cpu, as above)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    recipe = _task(tmp_path)
    if cli in TRAINING_CLIS:
        main, argv = _training_cli(tmp_path, recipe, cli)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
        assert not (tmp_path / "port").exists()
        return
    if cli == "phone_probs":
        (tmp_path / "port").mkdir()
        main, argv = t_phone_probs, [
            "-b", str(tmp_path / "am"), "-c", str(tmp_path / "feats.cfg"),
            "-r", str(recipe), "-o", str(tmp_path / "port")]
    else:
        main = t_recognize
        argv = _args(tmp_path, recipe, "port") + ["--engine", "dense"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    assert not list((tmp_path / "port").rglob("*.lna"))


def train_step_on_default_mesh(device="cuda"):
    """`sharded_train_step` on the mesh a caller builds by default."""
    return sharded_train_step(make_mesh(device=device), num_trans_slots=1)


@pytest.mark.parametrize("cls", [PhoneProbs, DenseBeamSearch, BeamSearch,
                                 Toolbox, FeatureGenerator,
                                 GmmScorer.from_model, EStepDriver,
                                 make_mesh, global_mesh,
                                 train_step_on_default_mesh, graft_entry])
def test_entry_points_default_to_cuda(monkeypatch, cls):
    """The public constructors default to the GPU and, with none, raise
    before reading anything or starting a process group."""
    assert inspect.signature(cls).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if cls is PhoneProbs:
            cls("no-model-read-before-the-device-check", "feats.cfg")
        elif cls in (DenseBeamSearch, BeamSearch):
            cls(None, None, None)
        elif cls is EStepDriver:
            cls(None, "no-config-read-before-the-device-check")
        elif cls in (make_mesh, global_mesh, train_step_on_default_mesh,
                     graft_entry):
            cls()
        else:               # a config path / a model never read
            cls("no-file-read-before-the-device-check")
    assert not torch.distributed.is_initialized()
