"""PyTorch port, the rest of the feature frontend: the vtln, concat,
sr_norm, quanteq and melpower ops, the ops' runtime parameters, the
`pre` base, `features_range`, speaker configurations and the splice and
VTLN configurations, against the JAX package on the same numpy inputs
(CPU).

Tolerance: rtol 1e-5, atol 1e-4 * max|output| — XLA and torch sum the
matmuls in different orders.  Tables built on the host by the copied
code (VTLN, speech-rate and parameter tables) must be identical.
"""

import io
import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aaltoasr_tpu.formats.feaconf import FeatureConfig as JConfig
from aaltoasr_tpu.formats.feaconf import ModuleConfig as JModCfg
from aaltoasr_tpu.formats.spkc import SpeakerConfig as JSpkc
from aaltoasr_tpu.frontend import modules as JM
from aaltoasr_tpu.frontend.generator import FeatureGenerator as JGen
from aaltoasr_tpu.frontend.generator import read_pre_file as j_read_pre

from aaltoasr_tpu_torch import convert, synth
from aaltoasr_tpu_torch.formats.feaconf import FeatureConfig as TConfig
from aaltoasr_tpu_torch.formats.feaconf import ModuleConfig as TModCfg
from aaltoasr_tpu_torch.formats.spkc import SpeakerConfig as TSpkc
from aaltoasr_tpu_torch.frontend import modules as TM
from aaltoasr_tpu_torch.frontend.generator import FeatureGenerator as TGen
from aaltoasr_tpu_torch.frontend.generator import read_pre_file as t_read_pre

from tests.test_frontend import cfg_mfcc_full, make_audio

# the tests run tiny tensors in several worker processes at once: one
# intra-op thread each avoids oversubscribing the cores
torch.set_num_threads(1)


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-4 * float(np.abs(want).max()))


def _cfg(items):
    items = [(k, str(v)) for k, v in items.items()]
    return JModCfg(list(items)), TModCfg(list(items))


def _ops(mtype, items, src_dims):
    jcfg, tcfg = _cfg(items)
    jop = JM.build_op(mtype, jcfg, src_dims, 16000)
    top = TM.build_op(mtype, tcfg, src_dims, 16000)
    assert (top.out_dim, top.left, top.right) == (
        jop.out_dim, jop.left, jop.right)
    return jop, top


def _apply_both(jop, top, srcs, jparams, tparams):
    """The same sources and parameter tables through both ops; the
    tables must be identical (the same numpy code built them)."""
    assert jparams.keys() == tparams.keys()
    for k in jparams:
        np.testing.assert_array_equal(np.asarray(tparams[k]),
                                      np.asarray(jparams[k]))
    want = jop.apply([jnp.asarray(s) for s in srcs],
                     {k: jnp.asarray(v) for k, v in jparams.items()})
    got = top.apply([torch.tensor(s) for s in srcs],
                    {k: torch.tensor(np.asarray(v))
                     for k, v in tparams.items()})
    _close(got, want)
    return got


def _spectra(rows, dim, seed):
    return np.abs(np.random.default_rng(seed).normal(
        0, 50, (rows, dim))).astype(np.float32)


# VTLN tables: piecewise linear, bilinear with sinc interpolation
# (Lanczos window on and off), bilinear with 2-tap linear interpolation,
# sine-log (SLAPT) bins, and the all-pass bilinear and SLAPT transforms
VTLN = {
    "pwlin": {"pwlin_vtln": 1},
    "blin-sinc-lanczos": {},
    "blin-sinc": {"lanczos_window": 0},
    "blin-linear": {"sinc_interpolation_rad": 0},
    "slapt-sinc": {"slapt": 1},
    "allpass-blin": {"all-pass": 1},
    "allpass-slapt": {"all-pass": 1, "slapt": 1},
}
WARPS = [0.86, 0.97, 1.0, 1.08, 1.17]


@pytest.mark.parametrize("warp", WARPS)
@pytest.mark.parametrize("kind", list(VTLN))
def test_vtln_matches_reference(kind, warp):
    jop, top = _ops("vtln", VTLN[kind], [65])
    if "slapt" in VTLN[kind]:
        block = {"slapt_coef": f"{warp - 1.0:.3f} {0.5 * (1.0 - warp):.3f}"}
    else:
        block = {"warp_factor": warp}
    jblock, tblock = _cfg(block)
    x = [_spectra(30, 65, seed=int(warp * 100))]
    got = _apply_both(jop, top, x, jop.set_parameters(jblock),
                      top.set_parameters(tblock))
    if top._clamp:                               # sinc and all-pass rows
        assert float(got.min()) >= 0.0
    _apply_both(jop, top, x, jop.init_params(), top.init_params())


def test_vtln_unit_warp_sinc_is_identity():
    """Warp 1.0 with the sinc table interpolates at the bins themselves."""
    _, top = _ops("vtln", {}, [65])
    x = torch.tensor(_spectra(12, 65, seed=1))
    params = top.set_parameters(_cfg({"warp_factor": 1.0})[1])
    out = top.apply([x], {k: torch.tensor(v) for k, v in params.items()})
    torch.testing.assert_close(out, x, rtol=1e-5, atol=1e-4 * 50)


def test_vtln_table_builders_are_the_reference_code():
    for dim, wf in ((16, 0.9), (65, 1.12)):
        for pw in (False, True):
            np.testing.assert_array_equal(
                TM.vtln_bins(dim, wf, pw, 0.8), JM.vtln_bins(dim, wf, pw, 0.8))
        bins = JM.vtln_bins(dim, wf, False, 0.8)
        for rad, lanczos in ((8, True), (8, False), (0, False)):
            t, tc = TM.vtln_matrix(dim, bins, rad, lanczos)
            j, jc = JM.vtln_matrix(dim, bins, rad, lanczos)
            np.testing.assert_array_equal(t, j)
            assert tc == jc
        np.testing.assert_array_equal(
            TM.all_pass_vtln_matrix(dim, TM.all_pass_blin_matrix(dim, wf)),
            JM.all_pass_vtln_matrix(dim, JM.all_pass_blin_matrix(dim, wf)))
        np.testing.assert_array_equal(
            TM.all_pass_slapt_matrix(dim, [0.03, -0.01]),
            JM.all_pass_slapt_matrix(dim, [0.03, -0.01]))


@pytest.mark.parametrize("left,right", [(0, 0), (1, 1), (2, 1), (0, 3)])
def test_concat_matches_reference(left, right):
    jop, top = _ops("concat", {"left": left, "right": right}, [5])
    x = [np.random.default_rng(left + 4 * right).normal(
        0, 3, (20 + left + right, 5)).astype(np.float32)]
    got = _apply_both(jop, top, x, {}, {})
    assert got.shape == (20, 5 * (left + right + 1))


@pytest.mark.parametrize("rate", [0.7, 1.0, 1.3])
@pytest.mark.parametrize("frames", [(5, 5), (7, 3), (4, 6)])
def test_sr_norm_matches_reference(frames, rate):
    in_f, out_f = frames
    items = {"in_frames": in_f, "out_frames": out_f, "lanczos_order": 3}
    jop, top = _ops("sr_norm", items, [in_f * 4])
    x = [np.random.default_rng(in_f).normal(
        0.5, 1.0, (18, in_f * 4)).astype(np.float32)]
    jblock, tblock = _cfg({"speech_rate": rate})
    got = _apply_both(jop, top, x, jop.set_parameters(jblock),
                      top.set_parameters(tblock))
    assert float(got.min()) >= 0.0                  # the relu clamp


@pytest.mark.parametrize("identity", [True, False])
def test_quanteq_matches_reference(identity):
    jop, top = _ops("quanteq", {}, [6])
    rng = np.random.default_rng(3)
    x = [np.abs(rng.normal(2, 1, (15, 6))).astype(np.float32)]
    block = {} if identity else {
        "alpha": "0.9 0.8 1.0 0.95 0.7 0.85",
        "gamma": "1.1 0.9 1.0 1.2 0.8 1.05",
        "quant_max": "4 5 3.5 6 4.5 5.5"}
    jblock, tblock = _cfg(block)
    got = _apply_both(jop, top, x, jop.set_parameters(jblock),
                      top.set_parameters(tblock))
    if identity:
        np.testing.assert_array_equal(got.numpy(), x[0])
    else:
        assert not np.allclose(got.numpy(), x[0])


def test_melpower_matches_reference():
    jop, top = _ops("melpower", {}, [21])
    x = [np.random.default_rng(4).normal(2, 1, (17, 21)).astype(np.float32)]
    _apply_both(jop, top, x, {}, {})


@pytest.mark.parametrize("mtype,items,block,src", [
    ("normalization", {}, {"mean": "1 2 3", "scale": "0.5 2 1"}, 3),
    ("normalization", {"mean": "1 1 1"}, {"var": "4 1 0.25"}, 3),
    ("lin_transform", {"dim": 2}, {"matrix": "1 2 3 4 5 6",
                                   "bias": "0.5 -1"}, 3),
    ("lin_transform", {}, {"bias": "1 2 3"}, 3),
])
def test_set_parameters_match_reference(mtype, items, block, src):
    jop, top = _ops(mtype, items, [src])
    jblock, tblock = _cfg(block)
    x = [np.random.default_rng(5).normal(0, 2, (9, src)).astype(np.float32)]
    _apply_both(jop, top, x, jop.set_parameters(jblock),
                top.set_parameters(tblock))


def test_ops_without_parameters_refuse_a_block():
    _, top = _ops("delta", {}, [4])
    with pytest.raises(ValueError, match="no runtime parameters"):
        top.set_parameters(TModCfg())


# -- the generator --------------------------------------------------------

CONFIGS = {
    "splice": synth.splice_cfg(ceps=5, out_dim=8),
    "vtln-sinc": synth.vtln_cfg(ceps=3),
    "vtln-allpass": synth.vtln_cfg(ceps=3, **{"all-pass": 1}),
    "vtln-pwlin": synth.vtln_cfg(ceps=3, pwlin_vtln=1),
}


def _gens(text):
    return JGen(JConfig.parse(text)), TGen(TConfig.parse(text), device="cpu")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_generator_configuration(name):
    """The splice configuration fuses downstream of the dct; the VTLN
    configurations do not (the fft feeds the vtln module), in JAX as in
    the port."""
    jg, tg = _gens(CONFIGS[name])
    assert tg.dim == jg.dim and tg.need == jg.need
    assert (tg._fusion is not None) == (jg._fusion is not None) == (
        name == "splice")
    audio = make_audio(7000, seed=9)
    _close(tg.features(audio), jg.features(audio))


@pytest.mark.parametrize("start,end", [(-10, 12), (-3, 0), (4, 30),
                                       (40, 60), (50, 58)])
def test_features_range(start, end):
    """Negative starts and ends past the last frame (51 here) give border
    copies, as feacat's --start-frame/--end-frame do in the reference."""
    text = cfg_mfcc_full()
    jg, tg = _gens(text)
    audio = make_audio(6800, seed=10)
    assert tg.num_frames(6800) == 52
    got = tg.features_range(audio, start, end)
    assert got.shape == (end - start, tg.dim)
    _close(got, jg.features_range(audio, start, end))


def test_pre_base_through_read_pre_file(tmp_path):
    """Features written as a `pre` file (int32 dim header + float32
    frames, as feacat -H --raw-output writes them) and read back through
    a `pre` base with deltas and a splice."""
    feats = np.random.default_rng(11).normal(0, 2, (23, 4)).astype("<f4")
    path = tmp_path / "x.fea"
    path.write_bytes(struct.pack("<i", 4) + feats.tobytes())
    text = ("module\n{\n  name pre\n  type pre\n  dim 4\n}\n"
            "module\n{\n  name delta\n  type delta\n  sources pre\n"
            "  width 2\n}\n"
            "module\n{\n  name both\n  type merge\n  sources pre delta\n}\n"
            "module\n{\n  name splice\n  type concat\n  sources both\n"
            "  left 1\n  right 2\n}\n")
    jg, tg = _gens(text)
    loaded = t_read_pre(str(path), tg.module_dim("pre"))
    np.testing.assert_array_equal(loaded, j_read_pre(str(path), 4))
    np.testing.assert_array_equal(loaded, feats)
    assert tg.num_frames(23) == 23 and tg.dim == jg.dim == 32
    _close(tg.features(loaded), jg.features(loaded))
    _close(tg.features_range(loaded, -4, 27),
           jg.features_range(loaded, -4, 27))
    with pytest.raises(ValueError, match="invalid dimension"):
        t_read_pre(str(path), 5)


def _speaker_cfgs(text):
    return JSpkc.parse(text), TSpkc.parse(text)


@pytest.mark.parametrize("name,kind", [("vtln-sinc", "vtln"),
                                       ("vtln-allpass", "vtln"),
                                       ("splice", "lin_transform")])
def test_apply_speaker_config(name, kind):
    """Per-speaker blocks replace the modules' tensors; each speaker's
    features match the reference generator's after the same switch."""
    jg, tg = _gens(CONFIGS[name])
    js, ts = _speaker_cfgs(synth.speaker_spkc(["a", "b", "c"], kind,
                                              dim=8, seed=2))
    audio = make_audio(5000, seed=12)
    outs = []
    for spk in ("a", "b", "c", "a"):
        jg.apply_speaker_config(js.speaker_params(spk))
        tg.apply_speaker_config(ts.speaker_params(spk))
        got = tg.features(audio)
        _close(got, jg.features(audio))
        outs.append(got)
    torch.testing.assert_close(outs[3], outs[0], rtol=0, atol=0)
    # the warp (or transform) changes the features between speakers
    assert float((outs[0] - outs[2]).abs().max()) > 1e-3


def test_normalization_speaker_block_and_batch_after_switch():
    """A normalization block by `set_parameters`, then `features_batch`
    after a switch of speaker."""
    text = cfg_mfcc_full().replace(
        "module\n{\n  name out\n  type merge\n  sources cms delta accel\n}\n",
        "module\n{\n  name merged\n  type merge\n  sources cms delta accel"
        "\n}\nmodule\n{\n  name out\n  type normalization\n"
        "  sources merged\n}\n")
    jg, tg = _gens(text)
    assert tg.dim == 39
    rng = np.random.default_rng(13)
    items = {"mean": " ".join(f"{v:.4f}" for v in rng.normal(0, 1, 39)),
             "var": " ".join(f"{v:.4f}" for v in rng.uniform(0.5, 2, 39))}
    jblock, tblock = _cfg(items)
    jg.set_parameters("out", jblock)
    tg.set_parameters("out", tblock)
    a = make_audio(5000, seed=14)
    b = np.zeros_like(a)
    b[:3600] = make_audio(3600, seed=15)
    lens = np.array([5000, 3600])
    _close(tg.features_batch(np.stack([a, b]), lens),
           jg.features_batch(np.stack([a, b]), lens))


def test_convert_carries_speaker_parameters():
    """`convert.feature_params` loads the reference generator's runtime
    parameters after `apply_speaker_config` into the port's generator."""
    jg, tg = _gens(CONFIGS["vtln-pwlin"])
    js, _ = _speaker_cfgs(synth.speaker_spkc(["a", "b"], "vtln"))
    jg.apply_speaker_config(js.speaker_params("a"))
    convert.feature_params(jg, tg)
    np.testing.assert_array_equal(
        tg._dev_params["vtln"]["warp_matrix"].numpy(),
        np.asarray(jg.params["vtln"]["warp_matrix"]))
    audio = make_audio(4500, seed=16)
    _close(tg.features(audio), jg.features(audio))


def test_print_dot_graph_matches_reference():
    jg, tg = _gens(CONFIGS["splice"])
    jout, tout = io.StringIO(), io.StringIO()
    jg.print_dot_graph(jout)
    tg.print_dot_graph(tout)
    assert tout.getvalue() == jout.getvalue()
    assert "splice -> lda" in tout.getvalue()
