"""The MFCC-core kernel's 3xTF32 arithmetic, checked on the CPU.

The kernel (`aaltoasr_tpu_torch/csrc/mfcc_core.cu`) runs the DFT product
on the tensor cores with every float32 operand split into TF32 hi and
lo parts.  These tests pin what the wrapper prepares for it (the split,
the basis layout, the mel table) and, with a torch function written like
the kernel's arithmetic, that three TF32 products per k-step stay inside
the kernel tests' tolerance (rtol 1e-5, atol 1e-4 * max|value|) of the
float32 plain version, where one TF32 product does not.

This file imports no jax: the plain version is the reference here (it is
held against the JAX kernel in `test_torch_frontend.py`).
"""

import numpy as np
import pytest
import torch

from aaltoasr_tpu_torch.formats.feaconf import FeatureConfig
from aaltoasr_tpu_torch.frontend.generator import FeatureGenerator
from aaltoasr_tpu_torch.ops.frontend_cuda import (
    CHUNK, KPAD, TILES, basis_layout, mel_table, pick_tile, prepared_tables,
    reference_core, round_tf32, split_tf32)
from aaltoasr_tpu_torch.synth import mfcc_cfg, probe_frames

torch.set_num_threads(1)

RATES = [8000, 16000, 22050, 32000, 44100, 48000]  # W = 128 ... 768
KINDS = ["loud", "quiet", "tone"]


def mfcc_tables(rate, device="cpu", root=False, magnitude=True):
    """(dft basis, mel weights, dct matrix) of the MFCC configuration at
    `rate`, as float32 tensors on `device`."""
    fg = FeatureGenerator(FeatureConfig.parse(
        mfcc_cfg(rate, root=root, magnitude=magnitude)), device=device)
    return (fg.ops["fft"].table("basis", device),
            fg.ops["mel"].table("weights", device),
            fg.ops["dct"].table("matrix", device))


def within(got, ref) -> bool:
    """The kernel tests' tolerance: rtol 1e-5, atol 1e-4 * max|ref|."""
    atol = 1e-4 * float(ref.abs().max())
    return bool(((got - ref).abs() <= atol + 1e-5 * ref.abs()).all())


def emulated_core(frames, dft_basis, mel_w, dct_m, products=3):
    """The kernel's arithmetic in torch: the laid-out basis and the frames
    split into TF32 parts, per k-step of 8 the float32 accumulator takes
    lo*hi, hi*lo, hi*hi (products=3) or hi*hi alone (products=1); re and
    im of bin k are columns 2k, 2k+1; mel from the per-bin band window."""
    T, W = frames.shape
    K = dft_basis.shape[1] // 2
    lay = basis_layout(dft_basis)
    bh, bl = split_tf32(lay)
    f = torch.zeros((T, lay.shape[1]))
    f[:, :W] = frames
    ah, al = split_tf32(f)
    acc = torch.zeros((T, lay.shape[0]))
    for k in range(0, lay.shape[1], 8):
        s = slice(k, k + 8)
        if products == 3:
            acc = acc + al[:, s] @ bh[:, s].T
            acc = acc + ah[:, s] @ bl[:, s].T
        acc = acc + ah[:, s] @ bh[:, s].T
    re, im = acc[:, 0:2 * K:2], acc[:, 1:2 * K:2]
    spec = torch.sqrt(re * re + im * im)
    pw = torch.log(spec.sum(dim=-1, keepdim=True) + 1e-10)
    weights, bands = mel_table(mel_w, K)
    bw = weights.shape[1]
    cols = (bands[:, None].long() + torch.arange(bw)).reshape(-1)
    contrib = (spec[:, :, None] * weights[None]).reshape(T, -1)
    mel = torch.zeros((T, mel_w.shape[1])).index_add_(1, cols, contrib)
    return torch.log1p(mel) @ dct_m, pw


def test_round_tf32_is_cvt_rna():
    """Round to nearest on the 13 low bits, ties away from zero."""
    half = 2.0 ** -11                # half a TF32 ulp at 1
    t = torch.tensor([1 + half, -(1 + half), 1 + half - 2.0 ** -23,
                      1 + 3 * half, 3.0, 0.0], dtype=torch.float32)
    want = [1 + 2 * half, -(1 + 2 * half), 1.0, 1 + 4 * half, 3.0, 0.0]
    got = round_tf32(t)
    assert got.tolist() == want
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()


def test_split_tf32_bounds():
    rng = np.random.default_rng(0)
    t = torch.tensor((rng.normal(0, 1, 20000)
                      * 10.0 ** rng.uniform(-6, 6, 20000)).astype(np.float32))
    hi, lo = split_tf32(t)
    for part in (hi, lo):
        assert (part.view(torch.int32) & 0x1FFF).eq(0).all()
    assert (lo.abs() <= 2.0 ** -11 * t.abs()).all()
    # two TF32 parts carry 22 of float32's 24 significand bits: the rest
    # is below 2^-22 |t|, and values of 22 bits split exactly
    assert ((t - (hi + lo)).abs() <= 2.0 ** -22 * t.abs()).all()
    e = torch.floor(torch.log2(t.abs().double()))
    t22 = (torch.round(t.double() * 2.0 ** (21 - e)) * 2.0 ** (e - 21)).float()
    hi22, lo22 = split_tf32(t22)
    assert torch.equal(hi22 + lo22, t22)


@pytest.mark.parametrize("rate", RATES)
def test_basis_layout_unpermutes_to_basis(rate):
    basis, _, _ = mfcc_tables(rate)
    W, two_k = basis.shape
    K = two_k // 2
    lay = basis_layout(basis)
    assert lay.shape[0] % CHUNK == 0 and lay.shape[1] % KPAD == 0
    assert lay.shape[0] >= two_k and lay.shape[1] >= W
    # each 8-column tile of a chunk holds re and im of the same 4 bins
    back = torch.cat([lay[0:two_k:2, :W].T, lay[1:two_k:2, :W].T], dim=1)
    assert torch.equal(back, basis)
    assert not lay[two_k:].any() and not lay[:, W:].any()


@pytest.mark.parametrize("rate", RATES)
def test_mel_table_expands_to_mel_weights(rate):
    _, mel_w, _ = mfcc_tables(rate)
    K, M = mel_w.shape
    rows = -(-2 * K // CHUNK) * CHUNK // 2
    weights, bands = mel_table(mel_w, rows)
    bw = weights.shape[1]
    assert bw <= 3                      # the triangles overlap 3 bands
    assert (bands >= 0).all() and (bands + bw <= M).all()
    dense = torch.zeros((rows, M))
    for q in range(bw):
        dense[torch.arange(rows), bands.long() + q] += weights[:, q]
    assert torch.equal(dense[:K], mel_w)
    assert not dense[K:].any()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("rate", [8000, 16000, 22050, 44100])
def test_3xtf32_chain_within_tolerance(rate, kind):
    basis, mel_w, dct = mfcc_tables(rate)
    frames = torch.tensor(probe_frames([kind], 48, basis.shape[0], rate,
                                       seed=rate))
    cep, pw = emulated_core(frames, basis, mel_w, dct, products=3)
    ref_cep, ref_pw = reference_core(frames, basis, mel_w, dct)
    assert within(cep, ref_cep)
    assert within(pw, ref_pw)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("rate", [8000, 16000, 22050, 44100])
def test_single_tf32_pass_fails_tolerance(rate, kind):
    """Why the split: one TF32 product misses the tolerance everywhere."""
    basis, mel_w, dct = mfcc_tables(rate)
    frames = torch.tensor(probe_frames([kind], 48, basis.shape[0], rate,
                                       seed=rate))
    cep, _ = emulated_core(frames, basis, mel_w, dct, products=1)
    ref_cep, _ = reference_core(frames, basis, mel_w, dct)
    assert not within(cep, ref_cep)


def test_prepared_tables_made_once_per_table():
    """The kernel's tables are made once per source table and made again
    when that table changes in place."""
    basis, mel_w, _ = mfcc_tables(16000)
    first = prepared_tables(basis, mel_w)
    assert all(a is b for a, b in zip(first, prepared_tables(basis, mel_w)))
    basis.mul_(2.0)
    hi, lo, weights, bands = prepared_tables(basis, mel_w)
    assert hi is not first[0]
    assert torch.equal(hi, 2.0 * first[0]) and torch.equal(lo, 2.0 * first[1])
    assert weights is first[2] and bands is first[3]


def test_pick_tile():
    big, small = TILES
    assert pick_tile(128_768, 132) == big          # the batch shape
    assert pick_tile(1_006, 132) == small          # one 8 s utterance
    assert pick_tile(big * 66, 132) == big         # half the SMs
    assert pick_tile(big * 65, 132) == small
