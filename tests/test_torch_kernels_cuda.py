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

import functools

import numpy as np
import pytest
import torch

from aaltoasr_tpu_torch.formats.feaconf import FeatureConfig
from aaltoasr_tpu_torch.formats.spkc import SpeakerConfig
from aaltoasr_tpu_torch.frontend.generator import FeatureGenerator
from aaltoasr_tpu_torch.ops import frontend_cuda, gmm_cuda
from aaltoasr_tpu_torch.ops.gmm import GmmScorer, quantize_lna_u16
from aaltoasr_tpu_torch.synth import (
    MFCC_CFG, cmllr_transforms, feature_model, mfcc_cfg, nearest_clusters,
    norm_stats, probe_frames, random_model, speaker_spkc, splice_cfg,
    uneven_model, vtln_cfg)
from aaltoasr_tpu_torch.train.mllr import apply_model_cmllr
from aaltoasr_tpu_torch.utils import profiling

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
    before = profiling.counter("k2.launches")
    cep, pw = frontend_cuda.mfcc_core(frames, basis, mel_w, dct,
                                      magnitude=magnitude, root=root,
                                      with_power=with_power)
    torch.cuda.synchronize()
    assert profiling.counter("k2.launches") == before + 1
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
    before = profiling.counter("k1.launches")
    out = gmm_cuda.gmm_state_ll(x, fused.we, dim)
    torch.cuda.synchronize()
    assert profiling.counter("k1.launches") == before + 1
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
    before = profiling.counter("k2.launches")
    fused = FeatureGenerator(cfg, fused_mfcc=True,
                             device=dev).features_batch(samples, lens)
    assert profiling.counter("k2.launches") == before + 1
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
    before = profiling.counter("k2.launches")
    fused = FeatureGenerator(cfg, fused_mfcc=True,
                             device=dev).features_batch(samples, lens)
    assert profiling.counter("k2.launches") == before + 1
    plain = FeatureGenerator(cfg, device=dev).features_batch(samples, lens)
    scale = float(plain.abs().max())
    torch.testing.assert_close(fused, plain, rtol=1e-5, atol=1e-4 * scale)


# -- the adaptation configurations (-S) and the full-cov / gated scorers --

ADAPT = {"splice": (splice_cfg, {}, "lin_transform"),
         "vtln-sinc": (vtln_cfg, {}, "vtln"),
         "vtln-allpass": (vtln_cfg, {"all-pass": 1}, "vtln")}


@functools.lru_cache(maxsize=None)
def _norm(name):
    """Mean and scale of the configuration's features over 2 s of noise,
    for its closing normalization module (as a `feanorm` file)."""
    cfg, items, _kind = ADAPT[name]
    fg = FeatureGenerator(FeatureConfig.parse(cfg(**items)), device="cpu")
    x = fg.features(np.random.default_rng(6).normal(0, 1000, 32000).astype(
        np.float32))
    return norm_stats(x.numpy())


def _speaker_generator(name, dev, fused_mfcc=False):
    """The configuration's generator (features normalized) with speaker
    "c"'s block applied: a feature transform near the identity, or the
    warp 1.1 (speakers a, b, c have 0.9, 1.0, 1.1)."""
    cfg, items, kind = ADAPT[name]
    text = cfg(norm=_norm(name), **items)
    fg = FeatureGenerator(FeatureConfig.parse(text), fused_mfcc=fused_mfcc,
                          device=dev)
    spkc = SpeakerConfig.parse(speaker_spkc(["a", "b", "c"], kind, dim=39))
    fg.apply_speaker_config(spkc.speaker_params("c"))
    return fg


@pytest.mark.parametrize("name", list(ADAPT))
def test_gmm_state_ll_on_adaptation_features(dev, name):
    """K1 on one 8 s utterance's features of the splice + LDA and VTLN
    configurations after a speaker switch, against a model placed on
    those features, matches its plain version."""
    fg = _speaker_generator(name, dev)
    rng = np.random.default_rng(7)
    x = fg.features(rng.normal(0, 1000, 128000).astype(np.float32))
    x = x.contiguous()
    fused = _fused(feature_model(random_model(G=900, S=300, D=39, K=8,
                                              seed=8), x.cpu().numpy(), 0.25),
                   dev)
    _check_gmm(fused, x, 300, atol=_loud_atol(fused, x, 300))


def test_fused_generator_splice_matches_unfused(dev):
    """The splice + LDA configuration fuses downstream of the dct: one K2
    launch per batch, and the spliced, transformed features agree with
    the unfused ops (rtol 1e-5, atol 1e-4 * max)."""
    rng = np.random.default_rng(9)
    samples = rng.normal(0, 1000, (3, 16000)).astype(np.float32)
    lens = np.array([16000, 12000, 9000])
    fused_fg = _speaker_generator("splice", dev, fused_mfcc=True)
    before = profiling.counter("k2.launches")
    fused = fused_fg.features_batch(samples, lens)
    assert profiling.counter("k2.launches") == before + 1
    plain = _speaker_generator("splice", dev).features_batch(samples, lens)
    scale = float(plain.abs().max())
    torch.testing.assert_close(fused, plain, rtol=1e-5, atol=1e-4 * scale)


@pytest.mark.parametrize("name", ["vtln-sinc", "vtln-allpass"])
def test_vtln_generator_does_not_launch_mfcc_core(dev, name):
    """The fft feeds the vtln module, so the MFCC core does not fuse."""
    fg = _speaker_generator(name, dev, fused_mfcc=True)
    assert fg._fusion is None
    before = profiling.counter("k2.launches")
    x = fg.features(np.random.default_rng(10).normal(
        0, 1000, 16000).astype(np.float32))
    assert profiling.counter("k2.launches") == before
    assert bool(torch.isfinite(x).all())


def _scorer_features():
    return np.random.default_rng(13).normal(0, 2, (1006, 39)).astype(
        np.float32)


def _scorer_pair(kind, dev):
    """(cuda, cpu) scorers of one model placed on the features (as in
    chip_smoke.py; peaked posteriors): "full" from model-space
    CMLLR with 4 classes, "gated" with 32 nearest-center clusters and
    eval_ming 0.1."""
    rng = np.random.default_rng(11)
    model = feature_model(random_model(G=600, S=200, D=39, K=4, seed=12),
                          _scorer_features(), 0.25)
    if kind == "full":
        model = apply_model_cmllr(model, cmllr_transforms(39, 4, rng),
                                  rng.integers(0, 4, 600))
    pair = [GmmScorer.from_model(model, device=d) for d in (dev, "cpu")]
    if kind == "gated":
        assign = nearest_clusters(model.means, 32)
        pair = [s.with_clustering(model, assign, 32, 0.0, 0.1) for s in pair]
    return pair


@pytest.mark.parametrize("kind", ["full", "gated"])
def test_scorer_on_cuda_matches_cpu(dev, kind):
    """The full-covariance and gated scorers (torch.matmul in IEEE
    float32, TF32 off) on the GPU against the CPU.  Full-cov sums 1,560
    terms of phi(x) that cancel down to the score, in another order on
    each side: atol 1e-5 * max|ll|, at least 1e-3.  The gate ranks
    clusters by float32 scores, so a near tie may select another
    cluster on one side: >= 99.9% of the scores within that tolerance.
    LNA codes within one step, >= 99% identical."""
    assert not torch.backends.cuda.matmul.allow_tf32
    cuda, cpu = _scorer_pair(kind, dev)
    x = _scorer_features()
    got = cuda.state_log_likelihoods(torch.tensor(x, device=dev))[:, :200]
    want = cpu.state_log_likelihoods(torch.tensor(x))[:, :200]
    atol = max(1e-3, 1e-5 * float(want.abs().max()))
    close = (got.cpu() - want).abs() <= atol
    if kind == "full":
        assert bool(close.all())
    else:
        assert float(close.float().mean()) >= 0.999
    codes = [quantize_lna_u16(s.lna_log_probs(torch.tensor(x, device=d)))
             .cpu().long() for s, d in ((cuda, dev), (cpu, "cpu"))]
    diff = (codes[0] - codes[1]).abs()
    assert int(diff.max()) <= 1 and float((diff == 0).float().mean()) >= 0.99
