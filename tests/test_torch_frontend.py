"""PyTorch port, feature frontend: each MFCC-path op, the generator and
the fused MFCC core's plain version, against the JAX package on the same
numpy inputs (CPU).

Tolerance: rtol 1e-5, atol 1e-4 * max|feature| — XLA and torch sum the
matmuls (DFT, mel, DCT) in different orders.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aaltoasr_tpu.formats.feaconf import FeatureConfig as JConfig
from aaltoasr_tpu.formats.feaconf import ModuleConfig as JModCfg
from aaltoasr_tpu.frontend import modules as JM
from aaltoasr_tpu.frontend.generator import FeatureGenerator as JGen
from aaltoasr_tpu.ops.frontend_pallas import mfcc_core as j_mfcc_core

from aaltoasr_tpu_torch.formats.feaconf import FeatureConfig as TConfig
from aaltoasr_tpu_torch.formats.feaconf import ModuleConfig as TModCfg
from aaltoasr_tpu_torch.frontend import modules as TM
from aaltoasr_tpu_torch.frontend.generator import FeatureGenerator as TGen
from aaltoasr_tpu_torch.ops.frontend_cuda import mfcc_core, reference_core
from aaltoasr_tpu_torch.synth import MFCC_CFG
from aaltoasr_tpu_torch.utils import profiling

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
    return JModCfg(list(items.items())), TModCfg(list(items.items()))


# (type, config items, source dims, input rows): every op the MFCC
# configurations use
OPS = [
    ("fft", {}, [256], 20),
    ("fft", {"magnitude": "0"}, [256], 20),
    ("mel", {}, [129], 20),
    ("mel", {"root": "1"}, [129], 20),
    ("power", {}, [129], 20),
    ("dct", {}, [21], 20),
    ("dct", {"dim": "13", "zeroth": "1"}, [21], 20),
    ("delta", {"width": "2"}, [13], 24),
    ("merge", {}, [12, 1], 20),
    ("normalization", {"mean": "1 2 3", "var": "4 5 6"}, [3], 20),
    ("lin_transform", {"dim": "2", "matrix": "1 2 3 4 5 6",
                       "bias": "0.5 -1"}, [3], 20),
    ("mean_subtractor", {"left": "3", "right": "2"}, [5], 26),
]


@pytest.mark.parametrize("mtype,items,src_dims,rows", OPS,
                         ids=[f"{o[0]}-{i}" for i, o in enumerate(OPS)])
def test_op_matches_reference(mtype, items, src_dims, rows):
    jcfg, tcfg = _cfg(items)
    jop = JM.build_op(mtype, jcfg, src_dims, 16000)
    top = TM.build_op(mtype, tcfg, src_dims, 16000)
    assert (top.out_dim, top.left, top.right) == (
        jop.out_dim, jop.left, jop.right)
    rng = np.random.default_rng(len(items) + rows)
    scale = 1000.0 if mtype == "fft" else 1.0
    srcs = [np.abs(rng.normal(0, scale, (rows, d))).astype(np.float32)
            for d in src_dims]
    jparams = {k: jnp.asarray(v) for k, v in jop.init_params().items()}
    tparams = {k: torch.tensor(np.asarray(v))
               for k, v in top.init_params().items()}
    want = jop.apply([jnp.asarray(s) for s in srcs], jparams)
    got = top.apply([torch.tensor(s) for s in srcs], tparams)
    _close(got, want)


def test_unported_ops_raise():
    """No module type is left unported: the port builds every type the
    JAX `build_op` builds, and an unknown type raises as there."""
    _, tcfg = _cfg({})
    for mtype in ("fft", "mel", "power", "melpower", "dct", "delta",
                  "normalization", "lin_transform", "merge",
                  "mean_subtractor", "concat", "vtln", "quanteq"):
        assert isinstance(TM.build_op(mtype, tcfg, [21], 16000), TM.Op)
    srn = _cfg({"in_frames": "3", "out_frames": "3"})[1]
    assert isinstance(TM.build_op("sr_norm", srn, [21], 16000), TM.SRNormOp)
    with pytest.raises(ValueError):
        TM.build_op("no_such_module", tcfg, [21], 16000)


@pytest.mark.parametrize("cfg_text", [MFCC_CFG, cfg_mfcc_full()],
                         ids=["mfcc", "mfcc_full"])
def test_generator_features(cfg_text):
    audio = make_audio(6000, seed=3)
    jg = JGen(JConfig.parse(cfg_text))
    tg = TGen(TConfig.parse(cfg_text), device="cpu")
    assert tg.dim == jg.dim and tg.need == jg.need
    assert tg.num_frames(6000) == jg.num_frames(6000)
    _close(tg.features(audio), jg.features(audio))


def test_generator_features_batch():
    a = make_audio(5000, seed=4)
    b = np.zeros_like(a)
    b[:3500] = make_audio(3500, seed=5)
    lens = np.array([5000, 3500])
    cfg = cfg_mfcc_full()
    want = JGen(JConfig.parse(cfg)).features_batch(np.stack([a, b]), lens)
    got = TGen(TConfig.parse(cfg), device="cpu").features_batch(
        np.stack([a, b]), lens)
    _close(got, want)


def test_non_integer_advance():
    cfg = MFCC_CFG.replace("sample_rate 16000",
                           "sample_rate 16000\n  frame_rate 120")
    audio = make_audio(4000, seed=6)
    _close(TGen(TConfig.parse(cfg), device="cpu").features(audio),
           JGen(JConfig.parse(cfg)).features(audio))


CORE_MODES = [(True, False, True), (True, False, False), (False, True, True)]
# 16 kHz keeps its ids; 8, 22.05 and 44.1 kHz give W = 128, 352, 705
CORE_CASES = ([pytest.param(*m, 16000, id="-".join(map(str, m)))
               for m in CORE_MODES]
              + [pytest.param(*m, rate, id="-".join(map(str, (rate, *m))))
                 for rate in (8000, 22050, 44100) for m in CORE_MODES])


@pytest.mark.parametrize("magnitude,root,with_power,rate", CORE_CASES)
def test_mfcc_core_plain_matches_pallas_interpret(magnitude, root,
                                                  with_power, rate):
    """The K2 kernel's plain version against the Pallas kernel in
    interpret mode (as tests/test_frontend_fused.py runs it)."""
    fg = TGen(TConfig.parse(MFCC_CFG.replace(
        "sample_rate 16000", f"sample_rate {rate}")), device="cpu")
    basis = fg.ops["fft"].basis
    mel_w = fg.ops["mel"].weights
    dct = fg.ops["dct"].matrix
    frames = np.random.default_rng(7).normal(
        0, 1000, (150, basis.shape[0])).astype(np.float32)
    want = j_mfcc_core(jnp.asarray(frames), jnp.asarray(basis),
                       jnp.asarray(mel_w), jnp.asarray(dct),
                       magnitude=magnitude, root=root,
                       with_power=with_power, interpret=True)
    args = [torch.tensor(a) for a in (frames, basis, mel_w, dct)]
    kw = dict(magnitude=magnitude, root=root, with_power=with_power)
    before = profiling.counter("k2.launches")
    got = mfcc_core(*args, **kw)            # CPU tensors: the plain version
    assert profiling.counter("k2.launches") == before
    np.testing.assert_array_equal(got[0].numpy(),
                                  reference_core(*args, **kw)[0].numpy())
    _close(got[0], want[0])
    if with_power:
        _close(got[1], want[1])
    else:
        assert got[1] is None


def test_fused_switch_needs_a_gpu_tensor():
    """fused_mfcc=True takes the kernel only for CUDA tensors; on the CPU
    the unfused ops run (as the reference gates on a TPU backend)."""
    audio = make_audio(4000, seed=8)
    before = profiling.counter("k2.launches")
    fused = TGen(TConfig.parse(MFCC_CFG), fused_mfcc=True, device="cpu")
    assert fused._fusion == {"fft": "fft", "mel": "mel", "dct": "dct",
                             "power": "power"}
    plain = TGen(TConfig.parse(MFCC_CFG), device="cpu")
    np.testing.assert_array_equal(fused.features(audio).numpy(),
                                  plain.features(audio).numpy())
    assert profiling.counter("k2.launches") == before
