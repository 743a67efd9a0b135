"""The GMM state-likelihood kernel's 3xTF32 arithmetic, checked on the CPU.

The kernel (`aaltoasr_tpu_torch/csrc/gmm_state_ll.cu`) runs the K slot
products on the tensor cores with every float32 operand split into TF32
hi and lo parts, and folds the slots with a one-exponential online
logsumexp.  These tests pin what the wrapper prepares for it (the slab
layout and its split), and, with torch functions written like the
kernel's arithmetic, that its products stay as close to float64 as the
float32 plain version and inside the kernel tests' tolerance of it, and
that the one-exponential fold equals the plain version's two-exponential
one.  The uneven-components model puts LOG_ZERO slots inside the real
states; its plain path is held against the JAX kernel in interpret mode.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aaltoasr_tpu.formats import model_io as J_io
from aaltoasr_tpu.ops.gmm import GmmScorer as JGmm
from aaltoasr_tpu.ops.gmm_pallas import FusedGmmScorer as JFused

from aaltoasr_tpu_torch.formats.feaconf import FeatureConfig
from aaltoasr_tpu_torch.frontend.generator import FeatureGenerator
from aaltoasr_tpu_torch.ops.gmm import GmmScorer, lna_normalize
from aaltoasr_tpu_torch.ops.gmm import quantize_lna_u16
from aaltoasr_tpu_torch.ops.gmm_cuda import (
    DEPTH_STEP, TILES, FusedGmmScorer, gmm_state_ll, pick_tile,
    reference_state_ll, slab_depth, slab_layout, slab_table, slab_tiles,
    smem_bytes)
from aaltoasr_tpu_torch.ops.logsemiring import LOG_ZERO
from aaltoasr_tpu_torch.ops.tf32 import split_tf32
from aaltoasr_tpu_torch.synth import MFCC_CFG, random_model, uneven_model

torch.set_num_threads(1)


def fused(model) -> FusedGmmScorer:
    return FusedGmmScorer.from_scorer(GmmScorer.from_model(model,
                                                           device="cpu"))


def mfcc_features(seconds=1.0, seed=0) -> torch.Tensor:
    """The port's MFCC features of noise audio, as K1 gets them."""
    fg = FeatureGenerator(FeatureConfig.parse(MFCC_CFG), device="cpu")
    rng = np.random.default_rng(seed)
    return fg.features(rng.normal(0, 1000, int(16000 * seconds)))


def fold_one_exp(es: torch.Tensor) -> torch.Tensor:
    """The kernel's fold of [K, ...] slot scores: d = e - m, u =
    exp(-|d|); d <= 0: s += u; else s = s*u + 1, m = e."""
    m, s = es[0], torch.ones_like(es[0])
    for e in es[1:]:
        d = e - m
        u = torch.exp(-d.abs())
        up = d > 0
        s = torch.where(up, s * u + 1.0, s + u)
        m = torch.where(up, e, m)
    return torch.where(m <= LOG_ZERO / 2, torch.full_like(m, LOG_ZERO),
                       m + torch.log(s))


def fold_two_exp(es: torch.Tensor) -> torch.Tensor:
    """The plain version's (and the Pallas kernel's) fold."""
    m, s = es[0], torch.ones_like(es[0])
    for e in es[1:]:
        m2 = torch.maximum(m, e)
        s = s * torch.exp(m - m2) + torch.exp(e - m2)
        m = m2
    return torch.where(m <= LOG_ZERO / 2, torch.full_like(m, LOG_ZERO),
                       m + torch.log(s))


def emulated_state_ll(x, we, dim, products=3):
    """The kernel's arithmetic in torch: [x^2, x, 1] and the laid-out
    slabs split into TF32 parts; per k-step of 8 the float32 accumulator
    takes lo*hi, hi*lo, hi*hi (products=3) or hi*hi alone (products=1);
    the slots folded with one exponential each."""
    depth = slab_depth(dim)
    T = x.shape[0]
    xq = torch.zeros((T, depth))
    xq[:, :dim] = x * x
    xq[:, dim:2 * dim] = x
    xq[:, 2 * dim] = 1.0
    ah, al = split_tf32(xq)
    bh, bl = split_tf32(slab_layout(we, dim))
    es = []
    for k in range(we.shape[0]):
        acc = torch.zeros((T, we.shape[2]))
        for c in range(0, depth, 8):
            s = slice(c, c + 8)
            if products == 3:
                acc = acc + al[:, s] @ bh[k][:, s].T
                acc = acc + ah[:, s] @ bl[k][:, s].T
            acc = acc + ah[:, s] @ bh[k][:, s].T
        es.append(acc)
    return fold_one_exp(torch.stack(es))


def jax_model(model):
    """The port's `HmmModel` as the JAX package's, for its scorers."""
    return J_io.HmmModel(
        dim=model.dim, cov_type=model.cov_type, means=model.means,
        covars=model.covars, mixtures=model.mixtures,
        phones=[J_io.HmmPhone(label=p.label, states=list(p.states))
                for p in model.phones],
        transitions=model.transitions)


# -- the slab tables ------------------------------------------------------

@pytest.mark.parametrize("D,K", [(13, 1), (39, 8), (226, 3)])
def test_slab_layout_transposes_live_rows(D, K):
    f = fused(random_model(G=4 * K + 20, S=9, D=D, K=K, seed=D))
    lay = slab_layout(f.we, D)
    Kw, Dq, Spp = f.we.shape
    depth = slab_depth(D)
    assert depth % DEPTH_STEP == 0 and 2 * D + 1 <= depth < 2 * D + 17
    assert lay.shape == (K, Spp, depth)
    assert torch.equal(lay[:, :, :2 * D + 1],
                       f.we[:, :2 * D + 1].transpose(1, 2))
    assert not lay[:, :, 2 * D + 1:].any()
    # the rows past 2D+1 the kernel never reads are zero in we too
    assert not f.we[:, 2 * D + 1:].any()


@pytest.mark.parametrize("D,K", [(39, 8), (13, 5)])
def test_slab_split_keeps_float32_and_log_zero(D, K):
    f = fused(uneven_model(G=50, S=30, D=D, K=K, seed=K))
    lay = slab_layout(f.we, D)
    hi, lo = split_tf32(lay)
    for part in (hi, lo):
        assert (part.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((hi + lo - lay).abs() <= 2.0 ** -21 * lay.abs()).all()
    # LOG_ZERO bias rows (padded slots, padded states) stay <= -1e29
    bias = lay[..., 2 * D]
    dead = bias <= LOG_ZERO / 2
    assert dead.any() and dead[:, f.num_states:].all()
    assert (hi[..., 2 * D][dead] <= -1e29).all()
    assert ((hi + lo)[..., 2 * D][dead] <= -1e29).all()


@pytest.mark.parametrize("D,K", [(39, 8), (13, 5)])
def test_slab_tiles_hold_each_slice_as_core_matrices(D, K):
    """Per (slot, 64-state tile, k-slice of 16): hi then lo, each as
    8 x 4 core matrices; state n's depth-vector c (of 4) is row n % 8 of
    core matrix (n / 8, c), as the kernel's ring stage holds it."""
    f = fused(uneven_model(G=50, S=70, D=D, K=K, seed=K))
    lay = slab_layout(f.we, D)
    tiles = slab_tiles(lay)
    Kw, Spp, depth = lay.shape
    assert tiles.shape == (K, Spp // 64, depth // 16, 2, 1024)
    for part, want in zip((tiles[:, :, :, 0], tiles[:, :, :, 1]),
                          split_tf32(lay)):
        n = torch.arange(64)[:, None, None]
        c = torch.arange(4)[None, :, None]
        e = torch.arange(4)[None, None, :]
        idx = ((n // 8) * 4 + c) * 32 + (n % 8) * 4 + e    # [64, 4, 4]
        got = part[..., idx]            # [K, tiles, slices, 64, 4, 4]
        got = got.permute(0, 1, 3, 2, 4, 5).reshape(K, Spp, depth)
        assert torch.equal(got, want)


def test_slab_table_made_once_per_slab_tensor():
    f = fused(random_model(G=40, S=9, D=7, K=3, seed=1))
    first = slab_table(f.we, 7)
    assert slab_table(f.we, 7) is first
    assert torch.equal(first, slab_tiles(slab_layout(f.we, 7)))
    f.we.mul_(2.0)
    again = slab_table(f.we, 7)
    assert again is not first
    assert torch.equal(again, slab_tiles(slab_layout(f.we, 7)))


def test_pick_tile_and_shared_memory():
    frames, states = TILES[0]
    assert pick_tile(39_936, 2560, 39, 132) == 0      # the batch shape
    assert pick_tile(1, 2560, 39, 132) == 1
    # the batch tile once its blocks fill the 132 SMs twice
    n = -(-2 * 132 // (3072 // states))                # frame tiles needed
    assert pick_tile(n * frames, 3072, 39, 132) == 0
    assert pick_tile((n - 1) * frames, 3072, 39, 132) == 1
    # D=226: the batch tile's xq does not fit, the small one does
    assert smem_bytes(0, slab_depth(226)) > 232448
    assert pick_tile(39_936, 2560, 226, 132) == 1
    with pytest.raises(ValueError, match="shared memory"):
        pick_tile(1000, 2560, 2000, 132)


# -- the arithmetic -------------------------------------------------------

def test_one_exp_fold_equals_two_exp_fold():
    rng = np.random.default_rng(0)
    K, T, S = 6, 40, 24
    es = rng.normal(-80, 30, (K, T, S)).astype(np.float32)
    es[1, :, :4] = es[0, :, :4]                  # ties: d == 0
    es[3:, :, 4:8] = LOG_ZERO                    # padded slots at the end
    es[0, :, 8:12] = LOG_ZERO                    # a padded first slot
    es[:, :, 12:16] = LOG_ZERO                   # fully padded columns
    es[:, :5, 16:] += rng.normal(0, 5e3, (K, 5, S - 16)).astype(np.float32)
    es = torch.tensor(es)
    one, two = fold_one_exp(es), fold_two_exp(es)
    live = two > LOG_ZERO / 2
    torch.testing.assert_close(one[live], two[live], rtol=1e-6, atol=2e-5)
    assert (one[~live] == LOG_ZERO).all() and (~live[:, 12:16]).all()
    assert live[:, :12].all()


def exact_state_ll(x, we, dim):
    """The plain version's formula in float64."""
    x, we = x.double(), we.double()
    xq = torch.cat([x * x, x, torch.ones_like(x[:, :1])], dim=1)
    return fold_two_exp(torch.stack([xq @ w[:2 * dim + 1] for w in we]))


def features(kind):
    """MFCC features of noise audio (|x| up to ~18), or uniform features
    with |x| up to 20 ("loud")."""
    if kind == "mfcc":
        return mfcc_features(seed=1)
    rng = np.random.default_rng(5)
    return torch.tensor(rng.uniform(-20, 20, (64, 39)).astype(np.float32))


# the kernel tests' tolerances against the plain version: atol 1e-3 for
# MFCCs (|ll| in the hundreds); for loud features (|ll| ~3e3), where
# float32 itself is ~2e-3 from float64, atol 2e-6 * max|ll|
def tolerance(kind, plain):
    return 1e-3 if kind == "mfcc" else 2e-6 * float(plain.abs().max())


@pytest.mark.parametrize("kind", ["mfcc", "loud"])
@pytest.mark.parametrize("model", ["random", "uneven"])
def test_3xtf32_chain_within_tolerance(model, kind):
    """The emulated chain against the plain version, within the kernel
    tests' tolerance, and against float64: no further from it than twice
    the float32 plain version."""
    if model == "random":
        m = random_model(G=400, S=120, D=39, K=8, seed=3)
    else:
        m = uneven_model(G=200, S=120, D=39, K=8, seed=3)
    f = fused(m)
    x = features(kind)
    S = f.num_states
    got = emulated_state_ll(x, f.we, 39)[:, :S]
    plain = reference_state_ll(x, f.we, 39)[:, :S]
    exact = exact_state_ll(x, f.we, 39)[:, :S]
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, plain, rtol=0,
                               atol=tolerance(kind, plain))
    err = float((got.double() - exact).abs().max())
    err_plain = float((plain.double() - exact).abs().max())
    assert err <= 2 * err_plain
    if kind == "mfcc":
        # LNA codes within one step of the plain version's, and as often
        # equal to float64's codes (on this small model fewer codes
        # saturate than at 2,500 states, so fewer are equal: ~98%)
        a, b, c = (quantize_lna_u16(lna_normalize(v)).long()
                   for v in (got, plain, exact))
        assert (a - b).abs().max() <= 1
        assert (a == c).double().mean() >= (b == c).double().mean() - 0.005


def test_single_tf32_pass_fails_tolerance():
    """Why the split: one TF32 product misses the tolerance by far."""
    f = fused(random_model(G=400, S=120, D=39, K=8, seed=3))
    x = mfcc_features(seed=1)
    got = emulated_state_ll(x, f.we, 39, products=1)[:, :120]
    plain = reference_state_ll(x, f.we, 39)[:, :120]
    assert float((got - plain).abs().max()) > 1e-2


# -- the uneven-components model ------------------------------------------

@pytest.mark.parametrize("D,K", [(7, 4), (39, 8)])
def test_uneven_model_plain_matches_pallas_interpret(D, K):
    """States with fewer than K components (LOG_ZERO slots inside the
    real states, a zero-weight first slot among them): the port's tables
    equal the JAX package's, and its plain path agrees with the Pallas
    kernel in interpret mode."""
    model = uneven_model(G=50, S=23, D=D, K=K, seed=D)
    jf = JFused.from_scorer(JGmm.from_model(jax_model(model)))
    tf = fused(model)
    np.testing.assert_array_equal(tf.we.numpy(), np.asarray(jf.we))
    ci = GmmScorer.from_model(model, device="cpu").comp_logw
    assert (ci[:23] <= LOG_ZERO / 2).any()
    x = np.random.default_rng(D).normal(0, 2, (29, D)).astype(np.float32)
    want = np.asarray(jf.state_log_likelihoods(jnp.asarray(x),
                                               interpret=True))
    got = gmm_state_ll(torch.tensor(x), tf.we, D).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got[:, :23], want[:, :23], rtol=0,
                               atol=1e-3 if D == 39 else 1e-4)
    assert (got[:, 23:] <= -1e29).all()
