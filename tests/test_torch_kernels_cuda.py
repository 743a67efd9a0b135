"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Both kernels run their products on the tensor cores as 3xTF32 (the GMM
kernel's K slot products, the MFCC kernel's DFT), which keeps float32's
accuracy; the plain versions run cuBLAS float32 matmuls (TF32 off).
They differ in summation order, hence the tolerances below.  Every test
here needs a CUDA device and skips without one; on the GPU host run

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py

(`--noconftest`: the suite's conftest configures jax, which the GPU
host does not have).  This file imports no jax.
"""

import numpy as np
import pytest
import torch

from aaltoasr_tpu_torch.formats.feaconf import FeatureConfig
from aaltoasr_tpu_torch.frontend.generator import FeatureGenerator
from aaltoasr_tpu_torch.ops import frontend_cuda, gmm_cuda
from aaltoasr_tpu_torch.ops.gmm import GmmScorer
from aaltoasr_tpu_torch.synth import (
    MFCC_CFG, mfcc_cfg, probe_frames, random_model, uneven_model)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the GPU host)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


RATES = [8000, 16000, 22050, 32000, 44100, 48000]  # W = 128 ... 768


def mfcc_tables(rate, dev, root=False, magnitude=True):
    fg = FeatureGenerator(FeatureConfig.parse(
        mfcc_cfg(rate, root=root, magnitude=magnitude)), device=dev)
    return (fg.ops["fft"].table("basis", dev),
            fg.ops["mel"].table("weights", dev),
            fg.ops["dct"].table("matrix", dev))


MODES = [(True, False, True), (True, False, False), (False, False, True),
         (True, True, True)]
# T at the edges of both tiles, one 8 s utterance, and a ragged batch
EDGES = {"1": lambda tile: 1, "tile-1": lambda tile: tile - 1,
         "tile+1": lambda tile: tile + 1, "1006": lambda tile: 1006,
         "4097": lambda tile: 4097}


@pytest.mark.parametrize("magnitude,root,with_power", MODES)
@pytest.mark.parametrize("edge", list(EDGES))
@pytest.mark.parametrize("tile", frontend_cuda.TILES)
@pytest.mark.parametrize("rate", RATES)
def test_mfcc_core_matches_plain(dev, monkeypatch, rate, tile, edge,
                                 magnitude, root, with_power):
    """Every window from W=128 (8 kHz) to W=768 (48 kHz); W=352 and above
    did not fit the shared memory of the earlier kernel."""
    monkeypatch.setattr(frontend_cuda, "pick_tile", lambda T, n: tile)
    basis, mel_w, dct = mfcc_tables(rate, dev, root=root,
                                    magnitude=magnitude)
    T = EDGES[edge](tile)
    frames = torch.tensor(probe_frames(["loud", "quiet", "tone"], T,
                                       basis.shape[0], rate, seed=T), device=dev)
    before = frontend_cuda.mfcc_core.launches
    cep, pw = frontend_cuda.mfcc_core(frames, basis, mel_w, dct,
                                      magnitude=magnitude, root=root,
                                      with_power=with_power)
    torch.cuda.synchronize()
    assert frontend_cuda.mfcc_core.launches == before + 1
    ref_cep, ref_pw = frontend_cuda.reference_core(
        frames, basis, mel_w, dct, magnitude=magnitude, root=root,
        with_power=with_power)
    # 3xTF32 and float32 sums in another order: rtol 1e-5, atol 1e-4 * max
    scale = float(ref_cep.abs().max())
    torch.testing.assert_close(cep, ref_cep, rtol=1e-5, atol=1e-4 * scale)
    if with_power:
        torch.testing.assert_close(pw, ref_pw, rtol=1e-5,
                                   atol=1e-4 * float(ref_pw.abs().max()))
    else:
        assert pw is None


def test_mfcc_core_rejects_bad_inputs(dev):
    basis, mel_w, dct = mfcc_tables(16000, dev)
    frames = torch.zeros(8, 256, device=dev)
    with pytest.raises(TypeError):
        frontend_cuda.mfcc_core(frames.double(), basis, mel_w, dct)
    with pytest.raises(ValueError):
        frontend_cuda.mfcc_core(torch.zeros(256, 8, device=dev).T, basis,
                                mel_w, dct)
    with pytest.raises(ValueError):
        frontend_cuda.mfcc_core(frames, basis.cpu(), mel_w, dct)


def _fused(model, dev):
    return gmm_cuda.FusedGmmScorer.from_scorer(
        GmmScorer.from_model(model, device=dev))


def _check_gmm(fused, x, S, atol=1e-3):
    """One launch, against the plain version: the 3xTF32 products and
    float32 sums in another order, atol 1e-3 at D=39 (as the parity
    tests), and padded states kept at LOG_ZERO."""
    dim = x.shape[1]
    before = gmm_cuda.gmm_state_ll.launches
    out = gmm_cuda.gmm_state_ll(x, fused.we, dim)
    torch.cuda.synchronize()
    assert gmm_cuda.gmm_state_ll.launches == before + 1
    ref = gmm_cuda.reference_state_ll(x, fused.we, dim)
    assert bool(torch.isfinite(out[:, :S]).all())
    torch.testing.assert_close(out[:, :S], ref[:, :S], rtol=0, atol=atol)
    assert bool((out[:, S:] <= -1e29).all())


def _loud_atol(fused, x, S):
    """For features far from N(0, 2^2) (|x| to 20, D=226), |ll| reaches
    thousands and float32 itself is ~1e-6 * |ll| from float64; two
    versions that sum in other orders differ by a few times that: atol
    5e-6 * max|ll|, and never below 1e-3."""
    ref = gmm_cuda.reference_state_ll(x, fused.we, x.shape[1])[:, :S]
    return max(1e-3, 5e-6 * float(ref.abs().max()))


# T at 1 and 5, at the edges of each tile, one 8 s utterance, a ragged one
GMM_EDGES = {"1": lambda tile: 1, "5": lambda tile: 5,
             "tile-1": lambda tile: tile - 1, "tile+1": lambda tile: tile + 1,
             "1006": lambda tile: 1006, "1249": lambda tile: 1249}


@pytest.mark.parametrize("S,K", [(37, 1), (37, 8), (600, 8), (64, 3),
                                 (65, 32), (512, 8)])
@pytest.mark.parametrize("edge", list(GMM_EDGES))
@pytest.mark.parametrize("tile", range(len(gmm_cuda.TILES)))
def test_gmm_state_ll_matches_plain(dev, monkeypatch, tile, edge, S, K):
    """Both tiles at T edges, S at state-tile edges (64, 65, 512), K from
    1 to 32."""
    monkeypatch.setattr(gmm_cuda, "pick_tile", lambda *a: tile)
    T = GMM_EDGES[edge](gmm_cuda.TILES[tile][0])
    fused = _fused(random_model(G=3 * S, S=S, D=39, K=K, seed=S + K), dev)
    g = torch.Generator(device=dev).manual_seed(T)
    x = torch.randn(T, 39, generator=g, device=dev) * 2.0
    _check_gmm(fused, x, S)


@pytest.mark.parametrize("T", [5, 1006])
@pytest.mark.parametrize("D", [13, 39, 226])
def test_gmm_state_ll_dims(dev, D, T):
    """D=226, the float32 kernel's limit, takes the one-utterance tile at
    every T."""
    fused = _fused(random_model(G=120, S=70, D=D, K=4, seed=D), dev)
    g = torch.Generator(device=dev).manual_seed(D)
    x = torch.randn(T, D, generator=g, device=dev) * 2.0
    _check_gmm(fused, x, 70, atol=_loud_atol(fused, x, 70))


def test_gmm_state_ll_uneven_model(dev):
    """States with 1 to 8 components and zero-weight first slots: LOG_ZERO
    slots inside the real states."""
    fused = _fused(uneven_model(G=400, S=300, D=39, K=8, seed=1), dev)
    g = torch.Generator(device=dev).manual_seed(0)
    _check_gmm(fused, torch.randn(1006, 39, generator=g, device=dev) * 2.0,
               300)


def test_gmm_state_ll_loud_features(dev):
    """|x| up to 20, as real MFCCs reach."""
    fused = _fused(random_model(G=900, S=300, D=39, K=8, seed=2), dev)
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.uniform(-20, 20, (1006, 39)).astype(np.float32),
                     device=dev)
    _check_gmm(fused, x, 300, atol=_loud_atol(fused, x, 300))


def test_gmm_state_ll_tile_switch(dev, monkeypatch):
    """Through `pick_tile` on both sides of the switch to the batch tile."""
    fused = _fused(random_model(G=1800, S=600, D=39, K=8, seed=4), dev)
    Spp = fused.we.shape[2]
    frames, states = gmm_cuda.TILES[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n = -(-2 * sms // (Spp // states))
    picked = []
    pick = gmm_cuda.pick_tile
    monkeypatch.setattr(gmm_cuda, "pick_tile",
                        lambda *a: picked.append(pick(*a)) or picked[-1])
    for T in ((n - 1) * frames, n * frames):
        g = torch.Generator(device=dev).manual_seed(T)
        _check_gmm(fused, torch.randn(T, 39, generator=g, device=dev) * 2.0,
                   600)
    assert picked == [1, 0]


def test_gmm_state_ll_rejects_bad_inputs(dev):
    model = random_model(G=40, S=12, D=39, K=3)
    fused = gmm_cuda.FusedGmmScorer.from_scorer(
        GmmScorer.from_model(model, device=dev))
    x = torch.zeros(16, 39, device=dev)
    with pytest.raises(TypeError):
        gmm_cuda.gmm_state_ll(x.half(), fused.we, 39)
    with pytest.raises(ValueError):
        gmm_cuda.gmm_state_ll(torch.zeros(39, 16, device=dev).T, fused.we,
                              39)
    with pytest.raises(ValueError):
        gmm_cuda.gmm_state_ll(x, fused.we[:, :, :100], 39)
    with pytest.raises(ValueError):
        gmm_cuda.gmm_state_ll(x, fused.we[:, :, :100].contiguous(), 39)
    with pytest.raises(ValueError):
        gmm_cuda.gmm_state_ll(x, fused.we.cpu(), 39)


def test_fused_generator_matches_unfused(dev):
    """FeatureGenerator(fused_mfcc=True) on the GPU goes through the
    kernel and agrees with the unfused ops."""
    rng = np.random.default_rng(0)
    samples = rng.normal(0, 1000, (3, 16000)).astype(np.float32)
    lens = np.array([16000, 12000, 9000])
    cfg = FeatureConfig.parse(MFCC_CFG)
    before = frontend_cuda.mfcc_core.launches
    fused = FeatureGenerator(cfg, fused_mfcc=True,
                             device=dev).features_batch(samples, lens)
    assert frontend_cuda.mfcc_core.launches == before + 1
    plain = FeatureGenerator(cfg, device=dev).features_batch(samples, lens)
    scale = float(plain.abs().max())
    torch.testing.assert_close(fused, plain, rtol=1e-5, atol=1e-4 * scale)


def test_fused_generator_44k_matches_unfused(dev):
    """At 44.1 kHz (W=705, 29 mel bands) the fused generator launches the
    kernel and agrees with the unfused ops; the earlier kernel raised
    here for want of shared memory."""
    rng = np.random.default_rng(1)
    samples = rng.normal(0, 1000, (2, 44100)).astype(np.float32)
    lens = np.array([44100, 30000])
    cfg = FeatureConfig.parse(mfcc_cfg(44100))
    before = frontend_cuda.mfcc_core.launches
    fused = FeatureGenerator(cfg, fused_mfcc=True,
                             device=dev).features_batch(samples, lens)
    assert frontend_cuda.mfcc_core.launches == before + 1
    plain = FeatureGenerator(cfg, device=dev).features_batch(samples, lens)
    scale = float(plain.abs().max())
    torch.testing.assert_close(fused, plain, rtol=1e-5, atol=1e-4 * scale)
