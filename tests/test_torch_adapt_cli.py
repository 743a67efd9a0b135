"""PyTorch port, the adaptation and tool CLIs: `phone_probs` with speaker
configurations (-S: feature transforms, VTLN warps, model-space CMLLR)
and Gaussian clustering (-C), `feacat` and `feadot`, against the JAX
package's CLIs on the same files (CPU; the port's tools get ``--device
cpu``, since they default to the GPU).

Tolerances: 2-byte LNA codes within one step and >= 99% identical (XLA
and torch sum in different orders); 4-byte log-probs within atol 2e-3
(scores of a few hundred, float32 sums in another order); the same
number of frames per file.  feacat's ASCII text is identical when both
tools print the same features, and within one step of the last printed
digit, >= 99% identical, when each computes its own.
"""

import numpy as np
import pytest
import torch

from aaltoasr_tpu.cli.feacat import main as j_feacat
from aaltoasr_tpu.cli.feadot import main as j_feadot
from aaltoasr_tpu.cli.phone_probs import main as j_phone_probs
from aaltoasr_tpu.formats import model_io as J_io
from aaltoasr_tpu.formats.feaconf import FeatureConfig as JConfig
from aaltoasr_tpu.formats.lna import read_lna
from aaltoasr_tpu.frontend.generator import FeatureGenerator as JGen
from aaltoasr_tpu.models.phone_probs import PhoneProbs as JPhoneProbs
from aaltoasr_tpu.train.gcluster import cluster_gaussians, write_gcl

from aaltoasr_tpu_torch import synth
from aaltoasr_tpu_torch.cli.feacat import main as t_feacat
from aaltoasr_tpu_torch.cli.feadot import main as t_feadot
from aaltoasr_tpu_torch.cli.phone_probs import main as t_phone_probs
from aaltoasr_tpu_torch.frontend import generator as T_gen
from aaltoasr_tpu_torch.models.phone_probs import PhoneProbs as TPhoneProbs

from tests.test_frontend import make_audio
from tests.test_gmm import random_model

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
