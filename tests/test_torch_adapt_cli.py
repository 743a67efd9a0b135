"""PyTorch port, the adaptation and tool CLIs: `phone_probs` with speaker
configurations (-S: feature transforms, VTLN warps, model-space CMLLR)
and Gaussian clustering (-C), `feacat` and `feadot`, and the estimation
CLIs `vtln`, `mllr`, `mllt`, `lda`, `quanteq`, `feanorm` and `segfea`,
against the JAX package's CLIs on the same files (CPU; the port's tools
get ``--device cpu``, since they default to the GPU).

Tolerances: 2-byte LNA codes within one step and >= 99% identical (XLA
and torch sum in different orders); 4-byte log-probs within atol 2e-3
(scores of a few hundred, float32 sums in another order); the same
number of frames per file.  feacat's ASCII text is identical when both
tools print the same features, and within one step of the last printed
digit, >= 99% identical, when each computes its own.
"""

import dataclasses

import numpy as np
import pytest
import torch

from aaltoasr_tpu.cli.align import main as j_align
from aaltoasr_tpu.cli.feacat import main as j_feacat
from aaltoasr_tpu.cli.feadot import main as j_feadot
from aaltoasr_tpu.cli.feanorm import main as j_feanorm
from aaltoasr_tpu.cli.lda import main as j_lda
from aaltoasr_tpu.cli.mllr import main as j_mllr
from aaltoasr_tpu.cli.mllt import main as j_mllt
from aaltoasr_tpu.cli.phone_probs import main as j_phone_probs
from aaltoasr_tpu.cli.quanteq import main as j_quanteq
from aaltoasr_tpu.cli.segfea import main as j_segfea
from aaltoasr_tpu.cli.vtln import main as j_vtln
from aaltoasr_tpu.formats import model_io as J_io
from aaltoasr_tpu.formats.feaconf import FeatureConfig as JConfig
from aaltoasr_tpu.formats.lna import read_lna
from aaltoasr_tpu.formats.spkc import SpeakerConfig as J_Spkc
from aaltoasr_tpu.frontend.generator import FeatureGenerator as JGen
from aaltoasr_tpu.models.phone_probs import PhoneProbs as JPhoneProbs
from aaltoasr_tpu.train.gcluster import cluster_gaussians, write_gcl

from aaltoasr_tpu_torch import synth
from aaltoasr_tpu_torch.cli.feacat import main as t_feacat
from aaltoasr_tpu_torch.cli.feadot import main as t_feadot
from aaltoasr_tpu_torch.cli.feanorm import main as t_feanorm
from aaltoasr_tpu_torch.cli.lda import main as t_lda
from aaltoasr_tpu_torch.cli.mllr import main as t_mllr
from aaltoasr_tpu_torch.cli.mllt import main as t_mllt
from aaltoasr_tpu_torch.cli.phone_probs import main as t_phone_probs
from aaltoasr_tpu_torch.cli.quanteq import main as t_quanteq
from aaltoasr_tpu_torch.cli.segfea import main as t_segfea
from aaltoasr_tpu_torch.cli.vtln import main as t_vtln
from aaltoasr_tpu_torch.frontend import generator as T_gen
from aaltoasr_tpu_torch.models.phone_probs import PhoneProbs as TPhoneProbs

from tests.test_frontend import make_audio
from tests.test_golden_adaptation import speaker_wave
from tests.test_golden_estimate import assert_models_close
from tests.test_gmm import random_model
from tests.test_train import three_state_model
from tests.test_train_cli import CFG as TRAIN_CFG
from tests.test_train_cli import write_corpus

# the tests run tiny tensors in several worker processes at once: one
# intra-op thread each avoids oversubscribing the cores
torch.set_num_threads(1)

SPEAKERS = ["s0", "s1", "s2"]
CFGS = {"splice": lambda norm=None: synth.splice_cfg(ceps=5, out_dim=8,
                                                     norm=norm),
        "vtln": lambda norm=None: synth.vtln_cfg(ceps=3, norm=norm)}


def _corpus(tmp_path, cfg_name, n_wavs=4):
    """WAVs of 5,000-8,000 samples, a recipe naming a speaker per line
    (three speakers), the feature configuration with its features
    normalized to zero mean and unit variance over these WAVs (as a
    `feanorm` file would), and a diagonal model whose means come from
    the features themselves, with variances of 8 to 32 times each
    dimension's variance (`synth.feature_model`).  Unnormalized features
    lie many times their spread from zero, so the expanded square [x^2,
    x] of the scores cancels, and float32 sums in another order then
    move codes by more than one step.  With 12 states every code lies
    inside the code range; with variances of a quarter of the features'
    (peaked posteriors), XLA's and torch's frontends, which differ in
    the sixth digit, move 4-7% of them by one step, and with these broad
    ones fewer than 0.3%."""
    audio = [make_audio(5000 + 1000 * u, seed=30 + u) for u in range(n_wavs)]
    plain = JGen(JConfig.parse(CFGS[cfg_name]()))
    norm = synth.norm_stats(np.concatenate(
        [np.asarray(plain.features(a)) for a in audio]))
    cfg = CFGS[cfg_name](norm)
    (tmp_path / "feats.cfg").write_text(cfg)
    fg = JGen(JConfig.parse(cfg))
    lines, feats = [], []
    for u, a in enumerate(audio):
        synth.write_wav(tmp_path / f"u{u}.wav", a)
        feats.append(np.asarray(fg.features(a)))
        lines.append(f"audio={tmp_path / f'u{u}.wav'} lna=u{u}.lna "
                     f"speaker={SPEAKERS[u % 3]} utterance=u{u}")
    (tmp_path / "r.recipe").write_text("\n".join(lines) + "\n")
    model = synth.feature_model(random_model(G=36, S=12, D=fg.dim, K=3,
                                             seed=41),
                                np.concatenate(feats), 16.0, seed=40)
    J_io.write_model(str(tmp_path / "am"), model)
    return model


CASES = {
    # -S: a feature-space transform per speaker (splice + LDA + cmllr)
    "splice-S": ("splice", "lin_transform", False, []),
    # -S: a VTLN warp factor per speaker
    "vtln-S": ("vtln", "vtln", False, []),
    # -C on the diagonal model
    "splice-C": ("splice", None, True, ["--eval-ming", "0.3"]),
    # -S with model-space CMLLR: a full-covariance scorer per speaker
    "model-cmllr-S": ("splice", "model", False, []),
    # -S and -C together, recipe sorted by speaker
    "vtln-S-C-sorted": ("vtln", "vtln", True,
                        ["--eval-minc", "0.4", "--sort-recipe"]),
}


def _run_phone_probs(tmp_path, case, nbytes):
    cfg_name, spkc, clusters, extra = CASES[case]
    model = _corpus(tmp_path, cfg_name)
    argv = ["-b", str(tmp_path / "am"), "-c", str(tmp_path / "feats.cfg"),
            "-r", str(tmp_path / "r.recipe"), "--lnabytes", str(nbytes)]
    if spkc == "model":
        text = synth.model_cmllr_spkc(SPEAKERS, model.dim,
                                      model.num_gaussians, classes=3)
    elif spkc:
        text = synth.speaker_spkc(SPEAKERS, spkc, dim=model.dim, seed=3)
    if spkc:
        (tmp_path / "sp.spkc").write_text(text)
        argv += ["-S", str(tmp_path / "sp.spkc")]
    if clusters:
        assign = cluster_gaussians(model.means, 6)
        write_gcl(str(tmp_path / "c.gcl"), assign, 6)
        argv += ["-C", str(tmp_path / "c.gcl")]
    argv += extra
    for main, out in ((j_phone_probs, "ref"), (t_phone_probs, "port")):
        (tmp_path / out).mkdir()
        dev = ["--device", "cpu"] if out == "port" else []
        assert main(argv + ["-o", str(tmp_path / out)] + dev) == 0
    return [(read_lna(str(tmp_path / "ref" / f"u{u}.lna")),
             read_lna(str(tmp_path / "port" / f"u{u}.lna")))
            for u in range(4)]


@pytest.mark.parametrize("nbytes", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_phone_probs_adaptation_matches_reference(tmp_path, case, nbytes):
    pairs = _run_phone_probs(tmp_path, case, nbytes)
    diffs = []
    for (ref, rb), (got, gb) in pairs:
        assert rb == gb == nbytes
        assert got.shape == ref.shape                # frames per file
        if nbytes == 2:
            diffs.append(np.abs(np.round(-1820.0 * (got.astype(np.float64)
                                                    - ref))).ravel())
        else:
            np.testing.assert_allclose(got, ref, rtol=0, atol=2e-3)
    if nbytes == 2:
        diff = np.concatenate(diffs)
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.99
    # speakers differ: the same model gives other scores per speaker
    assert not np.array_equal(pairs[0][1][0][:10], pairs[1][1][0][:10])


@pytest.mark.parametrize("what", ["clusters", "model-cmllr"])
def test_fused_refuses_clusters_and_model_cmllr(tmp_path, what):
    """fused=True meets -C or a model-namespace CMLLR block: ValueError,
    as in JAX."""
    model = _corpus(tmp_path, "splice")
    cfg = str(tmp_path / "feats.cfg")
    if what == "clusters":
        write_gcl(str(tmp_path / "c.gcl"), cluster_gaussians(model.means, 4),
                  4)
    else:
        (tmp_path / "m.spkc").write_text(synth.model_cmllr_spkc(
            ["s0"], model.dim, model.num_gaussians))
    for pp in (JPhoneProbs(str(tmp_path / "am"), cfg, fused=True),
               TPhoneProbs(str(tmp_path / "am"), cfg, fused=True,
                           device="cpu")):
        with pytest.raises(ValueError, match="fused scoring does not"):
            if what == "clusters":
                pp.read_clustering(str(tmp_path / "c.gcl"))
            else:
                pp.read_speaker_config(str(tmp_path / "m.spkc"))
                pp.set_speaker("s0")


# -- feacat / feadot ------------------------------------------------------

def _feacat_out(capsysbinary, main, argv):
    assert main(argv) == 0
    return capsysbinary.readouterr().out


@pytest.mark.parametrize("flags", [[], ["-s", "3", "-e", "17"],
                                   ["-s", "-4", "-e", "44"],
                                   ["-r", "-H", "-s", "2"], ["-r"]])
def test_feacat_text_identical_on_the_same_features(tmp_path, monkeypatch,
                                                    capsysbinary, flags):
    """With both generators handing the tools the same features, the
    tools' output is the same bytes: ASCII, raw and the -H header, and
    the frame range as the JAX tool cuts it."""
    (tmp_path / "f.cfg").write_text(CFGS["splice"]())
    synth.write_wav(tmp_path / "a.wav", make_audio(6000, seed=50))
    feats = np.random.default_rng(51).normal(0, 20, (45, 8)).astype(
        np.float32)
    monkeypatch.setattr(JGen, "features", lambda self, s: feats)
    monkeypatch.setattr(T_gen.FeatureGenerator, "features",
                        lambda self, s: torch.tensor(feats))
    argv = [str(tmp_path / "a.wav"), "-c", str(tmp_path / "f.cfg")] + flags
    ref = _feacat_out(capsysbinary, j_feacat, argv)
    got = _feacat_out(capsysbinary, t_feacat, argv + ["--device", "cpu"])
    assert got == ref and len(ref) > 50


@pytest.mark.parametrize("speaker", ["", "s2"])
def test_feacat_matches_reference(tmp_path, capsysbinary, speaker):
    """Each tool computes its own features (here the VTLN configuration,
    with a speaker's warp from -S): each tool's ASCII text is its raw
    output printed, the raw outputs agree within the frontend parity
    tests' tolerance, and so the texts have the same lines and fields,
    each within one step of the last printed digit, >= 95% identical
    (a field differs where a value lies within float32 rounding of a
    printing boundary)."""
    (tmp_path / "f.cfg").write_text(CFGS["vtln"]())
    (tmp_path / "sp.spkc").write_text(synth.speaker_spkc(SPEAKERS, "vtln"))
    synth.write_wav(tmp_path / "a.wav", make_audio(7000, seed=52))
    argv = [str(tmp_path / "a.wav"), "-c", str(tmp_path / "f.cfg"),
            "-w", str(tmp_path / "out.cfg")]
    if speaker:
        argv += ["-S", str(tmp_path / "sp.spkc"), "--speaker-id", speaker]
    ref = _feacat_out(capsysbinary, j_feacat, argv).decode().splitlines()
    got = _feacat_out(capsysbinary, t_feacat,
                      argv + ["--device", "cpu"]).decode().splitlines()
    assert len(got) == len(ref) == 53
    rf = [ln.split() for ln in ref]
    gf = [ln.split() for ln in got]
    assert [len(r) for r in gf] == [len(r) for r in rf] == [12] * 53
    assert [len(ln) for ln in got] == [len(ln) for ln in ref]
    r = np.asarray(rf, dtype=np.float64)
    g = np.asarray(gf, dtype=np.float64)
    assert np.abs(g - r).max() <= 1e-4 + 1e-9
    same = np.mean([a == b for ra, ga in zip(rf, gf) for a, b in zip(ra, ga)])
    assert same >= 0.95
    assert (tmp_path / "out.cfg").exists()
    raw_ref = np.frombuffer(_feacat_out(capsysbinary, j_feacat,
                                        argv + ["-r"]), "<f4")
    raw_got = np.frombuffer(_feacat_out(capsysbinary, t_feacat,
                                        argv + ["-r", "--device", "cpu"]),
                            "<f4")
    np.testing.assert_allclose(raw_got, raw_ref, rtol=1e-5,
                               atol=1e-4 * float(np.abs(raw_ref).max()))
    for text, raw in ((got, raw_got), (ref, raw_ref)):
        assert text == ["".join(f"{v:8.4f} " for v in row)
                        for row in raw.reshape(53, 12)]


@pytest.mark.parametrize("cfg", list(CFGS))
def test_feadot_matches_reference(tmp_path, capsys, cfg):
    (tmp_path / "f.cfg").write_text(CFGS[cfg]())
    assert j_feadot(["-c", str(tmp_path / "f.cfg")]) == 0
    ref = capsys.readouterr().out
    assert t_feadot(["-c", str(tmp_path / "f.cfg"), "--device", "cpu"]) == 0
    assert capsys.readouterr().out == ref


@pytest.mark.parametrize("tool", ["feacat", "feadot"])
def test_tools_without_device_raise_with_no_gpu(tmp_path, monkeypatch,
                                                tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "f.cfg").write_text(CFGS["splice"]())
    synth.write_wav(tmp_path / "a.wav", make_audio(3000, seed=53))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if tool == "feacat":
            t_feacat([str(tmp_path / "a.wav"), "-c", str(tmp_path / "f.cfg")])
        else:
            t_feadot(["-c", str(tmp_path / "f.cfg")])


# -- the estimation CLIs: vtln, mllr, mllt, lda, quanteq, feanorm, segfea --

def adapt_corpus(tmp_path, samples=6000, n_utts=2, var_scale=16.0,
                 utterance_ids=False, fit=False):
    """A two-speaker corpus (`tests/test_golden_adaptation.py`'s waves:
    speaker b spectrally scaled) with ``samples`` per WAV, transcripts
    ``_ a _``, a speaker and an utterance id per line and alignments
    from the JAX `align`; the configuration `synth.adapt_cfg` (vtln, 12
    features normalized over the corpus at warp 1, an `mllr` module) and
    the three-state model placed on those features
    (`synth.feature_model`, variances ``var_scale`` times theirs) as
    ``am``, or with ``fit`` that model re-estimated on the alignments
    (`_fit_to_alignments`).  Returns the recipe path."""
    rng = np.random.default_rng(11)
    waves = {(spk, u): speaker_wave(rng, spk[-1], samples + 400 * u)
             for spk in ("spk_a", "spk_b") for u in range(n_utts)}
    plain = JGen(JConfig.parse(synth.adapt_cfg(ceps=3)))
    feats = np.concatenate([np.asarray(plain.features(w.astype(np.float32)))
                            for w in waves.values()])
    mean, scale = synth.norm_stats(feats)
    (tmp_path / "adapt.cfg").write_text(synth.adapt_cfg(ceps=3,
                                                        norm=(mean, scale)))
    J_io.write_model(str(tmp_path / "am"), synth.feature_model(
        three_state_model(seed=0, D=feats.shape[1]), (feats - mean) * scale,
        var_scale, seed=12))
    lines = []
    for (spk, u), sig in waves.items():
        wav = tmp_path / f"{spk}_{u}.wav"
        synth.write_wav(wav, sig)
        (tmp_path / f"{spk}_{u}.phn").write_text("_\na\n_\n")
        lines.append(f"audio={wav} transcript={tmp_path}/{spk}_{u}.phn "
                     f"alignment={tmp_path}/{spk}_{u}.ali.phn "
                     f"speaker={spk}"
                     + (f" utterance={spk}_{u}" if utterance_ids else ""))
    (tmp_path / "recipe").write_text("\n".join(lines) + "\n")
    (tmp_path / "in.spkc").write_text(
        "speaker default\n{\n  vtln\n  {\n    warp_factor 1.0\n  }\n}\n")
    assert j_align(["-b", str(tmp_path / "am"), "-c",
                    str(tmp_path / "adapt.cfg"), "-r",
                    str(tmp_path / "recipe")]) == 0
    if fit:
        _fit_to_alignments(tmp_path, waves, var_scale)
    return tmp_path / "recipe"


def _fit_to_alignments(tmp_path, waves, var_scale):
    """One Viterbi re-estimation of ``am`` from the alignments: each
    state's two Gaussians at its frames' mean (+-0.1 of their spread),
    with ``var_scale`` times their variance."""
    from aaltoasr_tpu.formats.phn import read_phn
    from aaltoasr_tpu.train.vtln import alignment_frame_states
    model = J_io.read_model(str(tmp_path / "am"))
    fg = JGen(JConfig.load(str(tmp_path / "adapt.cfg")))
    frames = {s: [] for s in range(model.num_states)}
    for (spk, u), sig in waves.items():
        feats = np.asarray(fg.features(sig.astype(np.float32)))
        states = alignment_frame_states(
            model, read_phn(str(tmp_path / f"{spk}_{u}.ali.phn")))
        for t, s in enumerate(states[:len(feats)]):
            frames[int(s)].append(feats[t])
    means, covars = model.means.copy(), model.covars.copy()
    for s, (idx, _w) in enumerate(model.mixtures):
        x = np.asarray(frames[s], np.float64)
        for i, g in enumerate(idx):
            means[g] = x.mean(0) + (0.1 if i % 2 else -0.1) * x.std(0)
            covars[g] = var_scale * x.var(0)
    J_io.write_model(str(tmp_path / "am"), dataclasses.replace(
        model, means=means, covars=covars))


def _both(tmp_path, j_main, t_main, argv, out_flag, out_name):
    """Run the JAX and the port CLI on the same files; returns the two
    output paths (``ref_<name>``, ``port_<name>``)."""
    outs = []
    for main, tag in ((j_main, "ref"), (t_main, "port")):
        out = tmp_path / f"{tag}_{out_name}"
        dev = ["--device", "cpu"] if tag == "port" else []
        assert main(argv + [out_flag, str(out)] + dev) in (0, None)
        outs.append(out)
    return outs


def _names(cfg) -> list:
    return [k for k, _ in cfg.items()]


def _spkc_close(ref_path, port_path, atol):
    """Both .spkc files parse to the same speakers, utterances and
    blocks; integers and warps identical, other vectors within ``atol``
    of their scale (the largest entry, at least 1).  Returns the two
    configurations and the largest deviation found, over its scale."""
    ref, got = (J_Spkc.load(str(p)) for p in (ref_path, port_path))
    assert set(got.speakers) == set(ref.speakers)
    assert set(got.utterances) == set(ref.utterances)
    worst = 0.0
    for table in ("speakers", "utterances"):
        for ident, blocks in getattr(ref, table).items():
            gblocks = getattr(got, table)[ident]
            assert set(gblocks) == set(blocks), ident
            for key, cfg in blocks.items():
                gcfg = gblocks[key]
                assert _names(gcfg) == _names(cfg), (ident, key)
                for name in _names(cfg):
                    a = np.asarray(cfg.get_float_vec(name), np.float64)
                    b = np.asarray(gcfg.get_float_vec(name), np.float64)
                    assert a.shape == b.shape, (ident, key, name)
                    if name in ("classes", "gauss_class", "warp_factor"):
                        np.testing.assert_array_equal(b, a)
                    else:
                        scale = max(1.0, float(np.abs(a).max()))
                        worst = max(worst, float(np.abs(b - a).max()) / scale)
                        np.testing.assert_allclose(
                            b, a, rtol=0, atol=atol * scale,
                            err_msg=f"{ident} {name}")
    return ref, got, worst


@pytest.mark.parametrize("opts", [
    [], ["-O"], ["--grid-size", "11", "--grid-rad", "0.05"], ["-S", "in"],
])
def test_vtln_cli_matches_reference(tmp_path, opts):
    """The same warp per speaker (each package's own frontend)."""
    recipe = adapt_corpus(tmp_path)
    opts = [str(tmp_path / "in.spkc") if o == "in" else o for o in opts]
    argv = ["-b", str(tmp_path / "am"), "-c", str(tmp_path / "adapt.cfg"),
            "-r", str(recipe)] + opts
    _spkc_close(*_both(tmp_path, j_vtln, t_vtln, argv, "-o", "vtln.spkc"),
                atol=0)


@pytest.mark.parametrize("opts", [
    [],                                         # below min_frames: identity
    ["--min-frames", "10"],
    ["-O", "--min-frames", "10"],
    ["--regtree-classes", "2", "--min-frames", "10"],
    ["--model-transform", "--min-frames", "10"],
    ["-S", "vtln", "--min-frames", "10"],       # vtln+mllr chaining
    # a prior for the first speaker only: the second keeps it (the
    # reference's caught KeyError)
    ["-S", "partial", "--min-frames", "10"],
])
def test_mllr_cli_matches_reference(tmp_path, opts):
    """Transforms within 1e-3 of their scale (each package's own frontend
    and float32 forward-backward, whose statistics differ by ~1e-4 of
    theirs); the chained output carries the VTLN blocks."""
    recipe = adapt_corpus(tmp_path)
    base = ["-b", str(tmp_path / "am"), "-c", str(tmp_path / "adapt.cfg"),
            "-r", str(recipe)]
    if "vtln" in opts:
        assert j_vtln(base + ["-o", str(tmp_path / "vtln.spkc")]) == 0
    (tmp_path / "partial.spkc").write_text(
        "speaker spk_a\n{\n  vtln\n  {\n    warp_factor 0.92\n  }\n}\n")
    opts = [str(tmp_path / f"{o}.spkc") if o in ("vtln", "partial") else o
            for o in opts]
    ref, got, worst = _spkc_close(*_both(
        tmp_path, j_mllr, t_mllr, base + opts, "-o", "mllr.spkc"), atol=1e-3)
    blocks = next(iter(got.speakers.values()))
    if "-S" in opts:
        assert ("feature", "vtln") in blocks
    if not opts:
        m = np.asarray(blocks[("feature", "mllr")].get_float_vec("matrix"))
        np.testing.assert_array_equal(m, np.eye(12).reshape(-1))
    print(f"largest |port - reference| / scale: {worst:.3g}")


def _train_corpus(tmp_path):
    """`tests/test_train_cli.py`'s corpus: three WAVs with transcripts and
    its configuration (an `mllt` lin_transform after the dct)."""
    recipe = write_corpus(tmp_path, np.random.default_rng(5))
    J_io.write_model(str(tmp_path / "am"), three_state_model(seed=5, D=4))
    (tmp_path / "feats.cfg").write_text(TRAIN_CFG)
    return recipe


def _config_close(ref_path, port_path, module, rtol, atol, rows=0):
    ref, got = (JConfig.load(str(p)) for p in (ref_path, port_path))
    assert [m.name for m in got.modules] == [m.name for m in ref.modules]
    for m in ref.modules:
        g = got.by_name[m.name].config
        assert _names(g) == _names(m.config), m.name
        if m.name != module:
            assert list(g.items()) == list(m.config.items()), m.name
    a = np.asarray(ref.by_name[module].config.get_float_vec("matrix"))
    b = np.asarray(got.by_name[module].config.get_float_vec("matrix"))
    if rows:                    # eigenvector rows: normalize their signs
        a, b = (m.reshape(rows, -1) for m in (a, b))
        b = b * np.sign((a * b).sum(1, keepdims=True))
    np.testing.assert_allclose(b, a, rtol=rtol, atol=atol)


def test_mllt_cli_matches_reference(tmp_path):
    """The transform in the output configuration and the rewritten model
    within rtol 1e-3 of the reference's."""
    recipe = _train_corpus(tmp_path)
    argv = ["-b", str(tmp_path / "am"), "-c", str(tmp_path / "feats.cfg"),
            "-r", str(recipe), "--iters", "5"]
    for main, tag in ((j_mllt, "ref"), (t_mllt, "port")):
        dev = ["--device", "cpu"] if tag == "port" else []
        assert main(argv + ["-o", str(tmp_path / f"{tag}_am"),
                            "-C", str(tmp_path / f"{tag}.cfg")] + dev) == 0
    _config_close(tmp_path / "ref.cfg", tmp_path / "port.cfg", "mllt",
                  rtol=1e-3, atol=1e-3)
    ref, got = (J_io.read_model(str(tmp_path / f"{t}_am"))
                for t in ("ref", "port"))
    assert_models_close(ref, got, rtol=1e-3)


LDA_CFG = TRAIN_CFG.replace("name mllt", "name lda").replace(
    "sources dct\n  dim 4", "sources dct\n  dim 2")


@pytest.mark.parametrize("opts,dim", [(["-O"], 2),
                                      (["-O", "--no-silence"], 1)])
def test_lda_cli_matches_reference(tmp_path, opts, dim):
    """The LDA matrix within rtol 1e-3 of the reference's, each row's
    sign normalized (each package's own frontend; the solve is the same
    float64 host code, whose eigenvector signs the inputs' last bits
    can flip).  The transcripts carry no times, so only the alignments
    (-O) give frames; without silence two states remain, whose
    between-class scatter has rank 1, so one dimension is defined."""
    recipe = adapt_corpus(tmp_path)
    (tmp_path / "lda.cfg").write_text(LDA_CFG)
    argv = ["-b", str(tmp_path / "am"), "-c", str(tmp_path / "lda.cfg"),
            "-r", str(recipe), "-d", str(dim), "--mingamma", "1"] + opts
    _config_close(*_both(tmp_path, j_lda, t_lda, argv, "-o", "lda.cfg"),
                  "lda", rtol=1e-3, atol=1e-4, rows=dim)


QE_CFG = """\
module
{
  name audio
  type audiofile
  sample_rate 16000
}
module
{
  name fft
  type fft
  sources audio
}
module
{
  name mel
  type mel
  sources fft
}
module
{
  name qe
  type quanteq
  sources mel
  quant_train 0.5 1.0 1.5 2.0
}
"""


@pytest.mark.parametrize("same", [False, True])
def test_quanteq_cli_matches_reference(tmp_path, monkeypatch, same):
    """Per-utterance (alpha, gamma) grid points identical and quant_max
    within rel 1e-4 on each package's own features; the same bytes when
    both read the reference's features."""
    from tests.test_torch_train_cli import use_reference_features
    if same:
        use_reference_features(monkeypatch)
    recipe = adapt_corpus(tmp_path, utterance_ids=True)
    (tmp_path / "qe.cfg").write_text(QE_CFG)
    (tmp_path / "prior.spkc").write_text(
        "speaker spk_a\n{\n  mllr\n  {\n    bias 1 2\n  }\n}\n")
    argv = ["-c", str(tmp_path / "qe.cfg"), "-r", str(recipe), "-q", "qe",
            "-S", str(tmp_path / "prior.spkc")]
    ref_path, port_path = _both(tmp_path, j_quanteq, t_quanteq, argv, "-o",
                                "qe.spkc")
    if same:
        assert port_path.read_bytes() == ref_path.read_bytes()
        return
    ref, got = (J_Spkc.load(str(p)) for p in (ref_path, port_path))
    assert set(got.utterances) == set(ref.utterances) and got.utterances
    for u, blocks in ref.utterances.items():
        a, b = blocks[("feature", "qe")], got.utterances[u][("feature", "qe")]
        for key in ("alpha", "gamma"):
            assert b.get_float_vec(key) == a.get_float_vec(key), (u, key)
        np.testing.assert_allclose(b.get_float_vec("quant_max"),
                                   a.get_float_vec("quant_max"), rtol=1e-4)
    assert got.speakers.keys() == ref.speakers.keys()


def test_quanteq_cli_refuses_other_module(tmp_path):
    (tmp_path / "qe.cfg").write_text(QE_CFG)
    (tmp_path / "r").write_text("audio=/nonexistent.wav\n")
    argv = ["-c", str(tmp_path / "qe.cfg"), "-r", str(tmp_path / "r"),
            "-q", "mel"]
    assert t_quanteq(argv + ["--device", "cpu"]) == j_quanteq(argv) == 1


def test_feanorm_cli_matches_reference(tmp_path):
    """Corpus mean and 1/std within rel 1e-4 of the reference's."""
    recipe = _train_corpus(tmp_path)
    cfg = TRAIN_CFG + ("module\n{\n  name norm\n  type normalization\n"
                       "  sources mllt\n}\n")
    (tmp_path / "n.cfg").write_text(cfg)
    argv = ["-c", str(tmp_path / "n.cfg"), "-r", str(recipe)]
    ref_path, port_path = _both(tmp_path, j_feanorm, t_feanorm, argv, "-o",
                                "n.cfg")
    ref, got = (JConfig.load(str(p)) for p in (ref_path, port_path))
    for key in ("mean", "scale"):
        np.testing.assert_allclose(
            got.by_name["norm"].config.get_float_vec(key),
            ref.by_name["norm"].config.get_float_vec(key), rtol=1e-4,
            atol=1e-6)


@pytest.mark.parametrize("opts", [["-O", "-s"], ["-O"]])
def test_segfea_cli_matches_reference(tmp_path, monkeypatch, opts):
    """On the reference's features: every state file and the occurrence
    counts byte for byte, with state segments (-s) and with phone
    segments divided between the states (the transcripts carry no
    times, so the alignments, -O, give the frames)."""
    from tests.test_torch_train_cli import use_reference_features
    use_reference_features(monkeypatch)
    recipe = adapt_corpus(tmp_path)
    (tmp_path / "bb").write_text("a 2 0 1\n_ 1 2\n")
    argv = ["-c", str(tmp_path / "adapt.cfg"), "-r", str(recipe),
            "-B", str(tmp_path / "bb")] + opts
    for main, tag in ((j_segfea, "ref"), (t_segfea, "port")):
        dev = ["--device", "cpu"] if tag == "port" else []
        assert main(argv + ["-o", str(tmp_path / tag), "--occ",
                            str(tmp_path / f"{tag}.occ")] + dev) == 0
    assert (tmp_path / "port.occ").read_bytes() == \
        (tmp_path / "ref.occ").read_bytes()
    files = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert files and sorted(p.name for p in (tmp_path / "port").iterdir()) \
        == files
    for name in files:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes()


ESTIMATION_CLIS = {
    "vtln": ["-c", "adapt.cfg", "-r", "recipe", "-b", "am", "-o", "x.spkc"],
    "mllr": ["-c", "adapt.cfg", "-r", "recipe", "-b", "am", "-o", "x.spkc"],
    "mllt": ["-c", "adapt.cfg", "-r", "recipe", "-b", "am", "-o", "x",
             "-C", "x.cfg"],
    "lda": ["-c", "adapt.cfg", "-r", "recipe", "-b", "am", "-o", "x.cfg",
            "-d", "2", "-M", "mllr"],
    "quanteq": ["-c", "adapt.cfg", "-r", "recipe", "-q", "mllr"],
    "feanorm": ["-c", "adapt.cfg", "-r", "recipe", "-o", "x.cfg"],
    "segfea": ["-c", "adapt.cfg", "-r", "recipe", "-B", "am.ph", "-o", "x"],
}


@pytest.mark.parametrize("cli", list(ESTIMATION_CLIS))
def test_estimation_clis_raise_with_no_gpu(tmp_path, monkeypatch, cli):
    """With no GPU and no --device the estimation CLIs raise before
    reading anything, and write nothing."""
    import importlib
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    main = importlib.import_module(f"aaltoasr_tpu_torch.cli.{cli}").main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(ESTIMATION_CLIS[cli])
    assert not list(tmp_path.iterdir())
