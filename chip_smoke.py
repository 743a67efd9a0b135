"""Smoke run of the PyTorch port on one CUDA GPU: kernels, then the serve path.

    python3 chip_smoke.py

Phases, each printing a summary line:
1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
2. the build of both CUDA kernels from `aaltoasr_tpu_torch/csrc/`;
3. the MFCC-core kernel against its plain PyTorch version, timed at the
   serve path's frontend batch (128 utterances x 8 s at 16 kHz) and at
   one 8 s utterance (the main path's launch), and checked once more at
   44.1 kHz (W=705);
4. the GMM state-likelihood kernel against its plain version at the
   bench scoring model (G=10,000, S=2,500, K=8, D=39; 32 x 10 s) and at
   one 8 s utterance against the main path's 2,704-state model, each
   beside a cuBLAS float32 product of the same shape (a yardstick of the
   product without the logsumexp, which the port never calls), with the
   LNA codes of kernel and plain version compared at the scoring model;
5. the main path: a synthetic 1,000-word cross-word triphone task with
   gamma durations and a trigram LM is written as files; `PhoneProbs`
   (fused scoring, fused MFCC) writes 2-byte LNAs for 4 WAVs of 8 s, and
   `cli.recognize --engine dense` decodes them.  The kernels' launch
   counters must show both kernels on this path, and every LNA code must
   be within one step of the plain path's;
6. the dense decoder at the bench operating point (B=128, T=1,000
   planted observations): planted-word agreement on the first 4
   utterances and the real-time factor;
7. speaker adaptation on the main path's WAVs (three speakers):
   `cli.phone_probs -S --fused` with a splice + LDA
   configuration and a feature transform per speaker (K2 and K1 launch
   once per utterance) and with VTLN configurations, sinc and all-pass,
   and a warp per speaker (K1 launches, K2 does not fuse), each against
   the plain path's LNA codes; warp 1.0 against the unwarped features;
   `-C` and a model-namespace CMLLR speaker (the full-covariance scorer)
   on the card against the CPU; then, at the bench scoring model, the
   full-covariance scorer (model CMLLR, 4 classes), the gated scorer
   (256 clusters, eval_ming 0.1), one model-CMLLR speaker switch, and
   the fused scoring batch of the MFCC and the splice + LDA
   configurations, timed;
8. the exact engine (`BeamSearch`, no kernel of its own): at the bench's
   cross-word point (`exact_crossword_trigram_xrt`: W=512, E=32, overflow
   128, prewalk 256, re-entry 8 + 8; B=128, T=1,000 planted
   observations), planted-word agreement on the first 4 utterances, the
   real-time factor and, from torch.profiler over 20 frames, kernel
   launches a frame and the device-busy share; the card against the CPU
   on 2 utterances (words, records and pointers identical); at the
   default knobs (W=1,024, E=128) on 4 utterances, planted words checked;
   then `recognize` at its default engine (exact on this task) on 2 of
   the planted utterances written as LNAs, planted words checked, and on
   the first of them on the CPU, whose line must be identical;
9. lattices, on the same task and planted observations: the dense
   engine at the `decode_xrt` point with lattice=False, lattice=True and
   bfloat16 records (words identical in all three, bfloat16 records
   within one bfloat16 step), timed, with the bytes fetched and the host
   time of `word_graph()` per utterance; the exact engine at phase 8's
   bench point on 2 utterances, the same; the first utterance of each
   on the card against the CPU (records, parsed SLF, nbest(5),
   confusion-network confidences); `recognize --lattices --nbest 3
   --confidence` with either engine on phase 8's planted LNAs, the first
   on the CPU too (1-best lines identical, SLF files alike);
   `decode --lattice-grammar` of the first SLF on the card and the CPU
   (identical lines) and `lattice_rescore --best` of it, timed;
10. streaming and the rest of the exact engine's options, on the same
   task: phase 8's first 2 planted utterances pushed to
   `StreamingDecoder` in 32-frame blocks at the default knobs (words
   identical to `BeamSearch.decode_batch`, `partial()` equal to
   `result().words` every 64 frames; ms per block, per `partial()` and
   for `result()`); `decode_stream` on 2 of phase 5's WAVs written as raw
   s16le, with the task's model placed on their features and no
   durations (x real time,
   K1 and K2 launches per block, both kernels at the block shape against
   their plain versions, `features_range` with the fused frontend over a
   growing buffer against the plain features), the first also on the CPU
   (words alike, or the difference traced to the fused scoring's near
   ties); then each option (context lookahead, `reentry_topk`,
   `reentry_preselect`, the five pruning beams, a two-member
   `InterNGramFsa`, word classes) at phase 8's bench point on 4 planted
   utterances of 500 frames (planted words checked), the first on the CPU
   too (words and records identical), timed.  Its CPU side runs in
   spawned worker processes beside the card's runs;
11. ML training, which launches neither kernel (both counters must stay
   at 0 over the phase): (a) the E-step (`train/estep.chain_stats`) at
   bench.py's `estep_fps` point (G=10,000, S=2,500, K=8, D=39, a
   256-label chain of 512 positions, B=32 utterances of T=1,000 frames)
   in both forward-backward forms, plain and shift-compiled: frames/s
   and x real time (median of 3 calls), peak device memory, and from
   torch.profiler over one call the kernel launches a frame and the
   device-busy share; the first utterance on the CPU in a worker, whose
   statistics the card's must match within twice the CPU's own spread
   between its two FB forms (the float32 noise floor at this size);
   (b) `align`, `stats` and `estimate` on 8 WAVs of 8 s with 100-label
   transcripts, normalized splice + LDA features and the same model as
   files, `stats` against the CPU by the same rule; (c) `train`, 2 EM
   iterations with a split, `--durations` and 256 clusters: the
   log-likelihood must rise and its first model match (b)'s estimate,
   each stage timed;
12. discriminative training on HMM networks, which launches the kernels
   only to score the WAVs it decodes into denominator networks: (a) at
   phase 11's E-step width (G=10,000, S=2,500, K=8, D=39) with a
   numerator network of one 256-label transcript and a denominator of it
   and 7 more (an 8-path union), T=1,000 frames of N(0, 2): the
   multipath-Viterbi FB, the MMI denominator pass (per-arc feature
   counts), `mpe_stats` in mpfe-pdf and `mpe_stats_seg` in mpe at
   max_seg_dur 64, each timed at B=1 and (but the segment mode, whose
   [T, P, D] tensors hold the card's memory) at B=32: frames/s, kernel
   launches a frame, device-busy share, peak memory; utterance 0 against
   the CPU in spawned workers (the segment mode on 24-label paths over
   120 frames); neither kernel may launch; (b) on the 1,000-word task's
   WAVs (4 x 8 s, random transcripts, the model placed on their
   features): `make_hmmnets -d` (K1 and K2 once per utterance each), on
   the first utterance `stats -H`, `-M mpv`, `--mmi` and `--mpe` in the
   mpe and mpfe-pdf error modes, `train_ebw --criterion mmi` for 2
   iterations (its first model against `estimate --mmi` on `stats
   --mmi`'s dumps), `opt_ebw_d`, and `recognize --stateseg` on 2 LNAs,
   each on the CPU too on the same files (networks from the card's
   log-probs and .stateseg files from the card's LNAs byte-identical;
   statistics and `train_ebw` from the card's features by (a)'s rule),
   each stage timed;
13. speaker adaptation and FST decoding, which launch neither kernel
   (both counters must stay at 0): (a) at phase 11's model width
   (G=10,000, S=2,500, K=8, D=39; the model placed on the features) on
   4 WAVs of 8 s from two speakers (`synth.speaker_wave`, the second
   spectrally scaled) through a VTLN + MLLR configuration
   (`synth.adapt_cfg`): `VtlnEstimator` over the 21-point grid with
   100-label transcripts and with an even state segmentation (-O),
   `CmllrEstimator` with 1 class and with 8 regression classes, per
   speaker timed (frames/s, peak memory) and one utterance profiled;
   the CPU in spawned workers on the same inputs (warps identical, or a
   near tie said so; curves rel 1e-5; statistics within twice the
   CPU's own spread between its two FB forms plus 1e-5 of scale;
   transforms within 1e-3 of scale or twice that spread); (b) `recognize
   --adapt` in each of vtln, mllr, vtln+mllr, cmllr on the 1,000-word
   task with those WAVs (the model placed on their features, the dense
   engine): the CPU's own .spkc against the card's (warps identical,
   transforms by (a)'s rule), then the CPU's `recognize` of the first
   utterance of each speaker on the card's .spkc and features: the same
   lines, LNA codes within one step and >= 99% identical, or, where
   float32 itself misses that (model CMLLR's full-covariance products),
   no further from the exact (float64) codes than twice the CPU; (c) `FstSearch` and `FstConfidence` over an 8-path
   hmmnet grammar and `MitFstSearch` with gamma durations over a
   30-phone loop, on (b)'s first 2 LNAs: words, paths and scores (rel
   1e-5) and confidences as the CPU's, ms a frame.

It then prints one JSON line of per-kernel results (each kernel's time
beside its bound: the larger of its bytes over 3.35 TB/s and its
products as 3xTF32 work over 495 TFLOP/s, the H100 SXM's published
rates) and, last, the device line.  It exits non-zero, before printing
any result, when no CUDA device is present or any check fails.  It
never imports jax.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

MFCC_SOURCE = "aaltoasr_tpu_torch/csrc/mfcc_core.cu"
GMM_SOURCE = "aaltoasr_tpu_torch/csrc/gmm_state_ll.cu"
MFCC_REPLACES = "aaltoasr_tpu/ops/frontend_pallas.py:60"
GMM_REPLACES = "aaltoasr_tpu/ops/gmm_pallas.py:144"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA's data sheet
TF32_FLOP_PER_S = 495e12       # dense TF32 tensor-core peak, the same
SPEAKERS = ("s0", "s1", "s2")
# the 1000-word cross-word triphone trigram task of phases 5-9
TASK = dict(num_words=1000, order=3, triphone=True, durations=True)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def timed_ms(fn, device, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds per call: CUDA events on a GPU, else the host
    clock (CPU rehearsal only)."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def graph_ms(fn, device, iters: int = 50, reps: int = 5,
             capture_error_mode: str = "global") -> float:
    """Device milliseconds per call: `iters` calls captured in a CUDA
    graph, replayed `reps` times between CUDA events (no host launch
    cost).  The host clock on a CPU (rehearsal only)."""
    if device.type != "cuda":
        return timed_ms(fn, device, iters=iters)
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode=capture_error_mode):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """(least ms, what sets it): `flops` of float32 products done as
    3xTF32 on the tensor cores, `nbytes` moved once through HBM."""
    ops_ms = 3 * flops / TF32_FLOP_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return ((ops_ms, "operations") if ops_ms >= bytes_ms
            else (bytes_ms, "bytes"))


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_build():
    from aaltoasr_tpu_torch.ops import cuda_build
    from aaltoasr_tpu_torch.ops.frontend_cuda import _lib as mfcc_lib
    from aaltoasr_tpu_torch.ops.gmm_cuda import _lib as gmm_lib
    sources = ("mfcc_core.cu", "gmm_state_ll.cu")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:   # one nvcc per source
        built = list(pool.map(cuda_build.build, sources))
    for source, (path, log) in zip(sources, built):
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"[2] build {source}: {time.perf_counter() - t0:.2f} s "
              f"(both in parallel) -> {path.name}; "
              f"{' | '.join(regs) or 'reused'}", flush=True)
    mfcc_lib()
    gmm_lib()


def _within(got, ref, rtol, atol) -> bool:
    return bool(((got - ref).abs() <= atol + rtol * ref.abs()).all())


def _mfcc_args(device, rate, n_utts, seconds, seed):
    """The frames the generator hands K2 for a [n_utts, seconds] batch of
    noise audio at `rate`, with the tables of the MFCC configuration."""
    from aaltoasr_tpu_torch.formats.feaconf import FeatureConfig
    from aaltoasr_tpu_torch.frontend.generator import FeatureGenerator
    from aaltoasr_tpu_torch.synth import mfcc_cfg
    fg = FeatureGenerator(FeatureConfig.parse(mfcc_cfg(rate)), device=device)
    n = int(rate * seconds)
    g = torch.Generator(device=device).manual_seed(seed)
    samples = torch.randn(n_utts, n, generator=g, device=device) * 1000.0
    T = fg.num_frames(n)
    nl, nr = fg.need["fft"]
    frames = fg._base_frames(
        samples, torch.full((n_utts,), T, device=device), nl, T, nr)
    frames = frames.reshape(-1, frames.shape[-1]).contiguous()
    return (frames, fg.ops["fft"].table("basis", device),
            fg.ops["mel"].table("weights", device),
            fg.ops["dct"].table("matrix", device))


def _mfcc_check(args):
    """K2 against its plain version on `args` -> (max |d|, within)."""
    from aaltoasr_tpu_torch.ops import frontend_cuda as FC
    cep, pw = FC.mfcc_core(*args)
    ref_cep, ref_pw = FC.reference_core(*args)
    err = max(float((cep - ref_cep).abs().max()),
              float((pw - ref_pw).abs().max()))
    # 3xTF32 and float32 sums in another order: rtol 1e-5, atol 1e-4 * max
    ok = (_within(cep, ref_cep, 1e-5, 1e-4 * float(ref_cep.abs().max()))
          and _within(pw, ref_pw, 1e-5, 1e-4 * float(ref_pw.abs().max())))
    return err, ok


def phase_mfcc(device, n_utts=128, seconds=8.0):
    """K2 at the two shapes the port launches: the frontend batch of the
    serve path (n_utts x seconds at 16 kHz) and one utterance, as
    `PhoneProbs.lna_codes` launches it on the main path; then once at
    44.1 kHz (W=705), a window the earlier kernel could not take."""
    from aaltoasr_tpu_torch.ops import frontend_cuda as FC
    res = {}
    for shape, n in (("batch", n_utts), ("utt", 1)):
        args = _mfcc_args(device, 16000, n, seconds, seed=2)
        err, ok = _mfcc_check(args)
        iters = 10 if shape == "batch" else 100
        ms = timed_ms(lambda: FC.mfcc_core(*args), device, iters=iters)
        plain_ms = timed_ms(lambda: FC.reference_core(*args), device,
                            iters=iters)
        T, W = args[0].shape
        tile = FC.pick_tile(T, torch.cuda.get_device_properties(
            device).multi_processor_count) if device.type == "cuda" else 0
        print(f"[3] mfcc_core {shape} ({T}, {W}) frames, tile {tile}: "
              f"max|d| {err:.3e} (rtol 1e-5, atol 1e-4*max) kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
        if not ok:
            fail(f"mfcc_core disagrees with its plain version ({shape})")
        res[shape] = (err, ms, plain_ms)
        if shape == "batch":
            # the DFT product's flops; frames read, cepstra + power written
            C = args[3].shape[1]
            k2_bound = bound(2.0 * T * W * args[1].shape[1],
                             4.0 * T * (W + C + 1))
    args = _mfcc_args(device, 44100, 8, 2.0, seed=3)
    err44, ok = _mfcc_check(args)
    print(f"[3] mfcc_core 44.1 kHz {tuple(args[0].shape)} frames: max|d| "
          f"{err44:.3e} (rtol 1e-5, atol 1e-4*max)", flush=True)
    if not ok:
        fail("mfcc_core disagrees with its plain version at 44.1 kHz")
    if device.type == "cuda":
        M = args[2].shape[1]
        smem = {t: FC._lib().mfcc_core_smem_bytes(t, M) for t in FC.TILES}
        print(f"[3] mfcc_core shared memory per block at M={M}: "
              + ", ".join(f"tile {t}: {b} B" for t, b in smem.items()),
              flush=True)
    return {"max_abs_err": max(res["batch"][0], res["utt"][0], err44),
            "ms": res["batch"][1], "plain_ms": res["batch"][2],
            "bound_ms": k2_bound[0], "bound_by": k2_bound[1],
            "library_ms": None,
            "utt_ms": res["utt"][1], "utt_plain_ms": res["utt"][2]}


def _gmm_shape(device, x, model, label, lna=False, tag="[4]"):
    """K1 on features `x` against `model`: checked against its plain
    version, timed beside it and beside the cuBLAS product of the same
    shape.  Returns (max |d|, kernel ms, plain ms, product ms, bound)."""
    from aaltoasr_tpu_torch.ops import gmm_cuda as GC
    from aaltoasr_tpu_torch.ops.gmm import (
        GmmScorer, lna_normalize, quantize_lna_u16)
    fused = GC.FusedGmmScorer.from_scorer(
        GmmScorer.from_model(model, device=device))
    we, D, S = fused.we, x.shape[1], fused.num_states
    K, _, Spp = we.shape
    T = x.shape[0]
    out = GC.gmm_state_ll(x, we, D)
    ref = GC.reference_state_ll(x, we, D)
    sync(device)
    err = float((out[:, :S] - ref[:, :S]).abs().max())
    pad_ok = bool((out[:, S:] <= -1e29).all())
    agree = ""
    if lna:
        got, want = (quantize_lna_u16(lna_normalize(v[:, :S])).long()
                     for v in (out, ref))
        steps = int((got - want).abs().max())
        same = int((got == want).sum())
        agree = (f"; LNA codes vs plain: max step {steps}, identical "
                 f"{same}/{got.numel()} ({100.0 * same / got.numel():.3f}%)")
        if steps > 1 or same < 0.99 * got.numel():
            fail(f"gmm_state_ll LNA codes off the plain version's ({label})")
    del out, ref
    # the product alone, [T, 2D+1] @ [2D+1, K*Spp], in cuBLAS float32
    xq = torch.cat([x * x, x, torch.ones_like(x[:, :1])], dim=1)
    w = we[:, :2 * D + 1].permute(1, 0, 2).reshape(2 * D + 1, K * Spp)
    w = w.contiguous()
    big = T * Spp > 1e7
    timer = timed_ms if big else graph_ms
    n = 5 if big else 50
    ms = timer(lambda: GC.gmm_state_ll(x, we, D), device, iters=n)
    plain_ms = timer(lambda: GC.reference_state_ll(x, we, D), device,
                     iters=n)
    mm_ms = timer(lambda: xq @ w, device, iters=n)
    flops = 2.0 * (2 * D + 1) * K * T * Spp
    # x read, the slabs' 2D+1 live rows read, the result written
    b = bound(flops, 4.0 * (T * D + K * (2 * D + 1) * Spp + T * Spp))
    print(f"{tag} gmm_state_ll {label} T={T} S={S} (Spp {Spp}) K={K} D={D}: "
          f"max|d| {err:.3e} (atol 1e-3), padded states <= -1e29: {pad_ok}"
          f"{agree}; kernel {ms:.4f} ms ({flops * 1e-9:.1f} GFLOP, "
          f"{flops / ms * 1e-9:.1f} TFLOP/s; bound {b[0]:.4f} ms by "
          f"{b[1]}, {100 * b[0] / ms:.0f}%), plain {plain_ms:.4f} ms, "
          f"cuBLAS float32 product alone (yardstick, no logsumexp) "
          f"{mm_ms:.4f} ms", flush=True)
    if not (err <= 1e-3 and pad_ok):
        fail(f"gmm_state_ll disagrees with its plain version ({label})")
    return err, ms, plain_ms, mm_ms, b


def _noise_batch(device, n_utts, seconds):
    """[n_utts, seconds at 16 kHz] N(0, 1000^2) samples on the device (seed
    0) and their lengths."""
    n = int(16000 * seconds)
    g = torch.Generator(device=device).manual_seed(0)
    return (torch.randn(n_utts, n, generator=g, device=device) * 1000.0,
            np.full(n_utts, n))


def _scoring_features(fg, samples, lens):
    feats = fg.features_batch(samples, lens)
    return feats.reshape(-1, feats.shape[-1]).contiguous()


def phase_gmm(device, task, n_utts=32, seconds=10.0, G=10000, S=2500, K=8):
    """K1 at the bench scoring model, on real features of noise audio,
    and at one 8 s utterance against the main path's model (K=1)."""
    from aaltoasr_tpu_torch.formats.feaconf import FeatureConfig
    from aaltoasr_tpu_torch.frontend.generator import FeatureGenerator
    from aaltoasr_tpu_torch.synth import MFCC_CFG, random_model
    fg = FeatureGenerator(FeatureConfig.parse(MFCC_CFG), device=device)
    samples, lens = _noise_batch(device, n_utts, seconds)
    x = _scoring_features(fg, samples, lens)
    err, ms, plain_ms, mm_ms, b = _gmm_shape(
        device, x, random_model(G=G, S=S, D=39, K=K), "scoring", lna=True)
    utt = fg.features(samples[0, :128000]).contiguous()
    err_u, ms_u, plain_u, mm_u, _ = _gmm_shape(device, utt, task.model,
                                               "one utterance")
    return {"max_abs_err": max(err, err_u), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b[0], "bound_by": b[1], "library_ms": None,
            "product_ms": mm_ms, "utt_ms": ms_u, "utt_plain_ms": plain_u,
            "utt_product_ms": mm_u}


def _read_codes(path) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    S = int.from_bytes(data[:4], "big")
    return np.frombuffer(data[5:], ">u2").reshape(-1, S).astype(np.int64)


def phase_main_path(device, task, workdir, n_wavs=4, seconds=8.0):
    """LNAs through both kernels, then `recognize --engine dense`.
    Returns the kernels' launch counts from this run and recognize's
    arguments for the task (no engine, no device)."""
    from aaltoasr_tpu_torch.cli import recognize
    from aaltoasr_tpu_torch.formats.feaconf import FeatureConfig
    from aaltoasr_tpu_torch.formats.recipe import Recipe
    from aaltoasr_tpu_torch.frontend.audio import read_audio
    from aaltoasr_tpu_torch.models.phone_probs import PhoneProbs
    from aaltoasr_tpu_torch.ops.frontend_cuda import mfcc_core
    from aaltoasr_tpu_torch.ops.gmm_cuda import gmm_state_ll
    from aaltoasr_tpu_torch.synth import write_task
    paths = write_task(task, workdir, num_wavs=n_wavs, seconds=seconds)
    cfg = FeatureConfig.load(paths["cfg"])
    recipe = Recipe.read(paths["recipe"])
    pp = PhoneProbs(paths["am"], cfg, lna_bytes=2, fused=True, device=device)
    task_argv = ["-b", paths["am"], "-c", paths["cfg"], "-l",
                 paths["lexicon"], "-n", paths["lm"], "-r", paths["recipe"],
                 "-w", workdir, "--dur", paths["am"] + ".dur"]
    argv = task_argv + ["--engine", "dense", "--device", device.type]

    mfcc_core.launches = 0
    gmm_state_ll.launches = 0
    sync(device)
    t0 = time.perf_counter()
    pp.generate_recipe(recipe)
    sync(device)
    t_lna = time.perf_counter() - t0
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = recognize.main(argv)
    sync(device)
    t_dec = time.perf_counter() - t0
    launches = {"mfcc_core": mfcc_core.launches,
                "gmm_state_ll": gmm_state_ll.launches}

    lines = [ln for ln in out.getvalue().splitlines() if ln.endswith(")")]
    for ln in lines:
        print(f"[5]   {ln}", flush=True)
    if rc not in (0, None) or len(lines) != n_wavs:
        fail(f"recognize returned {rc} with {len(lines)} result lines")
    if not all(ln.endswith(f"(u{i})") for i, ln in enumerate(lines)):
        fail("recognize result lines do not follow the recipe")
    if min(launches.values()) < 1:
        fail(f"a kernel was not launched on the main path: {launches}")
    if launches["gmm_state_ll"] != n_wavs:
        fail(f"gmm_state_ll: {launches['gmm_state_ll']} launches for "
             f"{n_wavs} utterances, not one each")

    # the plain path (unfused frontend, gather scorer) on the same card
    plain = PhoneProbs(paths["am"], cfg, lna_bytes=2, device=device)
    steps, same, total = 0, 0, 0
    for rinfo in recipe:
        samples, _ = read_audio(rinfo.audio_path, 16000)
        ref = plain.lna_codes(samples).cpu().numpy().astype(np.int64)
        got = _read_codes(rinfo.lna_path)
        if got.shape != ref.shape:
            fail(f"LNA shape {got.shape} != plain {ref.shape}")
        steps = max(steps, int(np.abs(got - ref).max()))
        same += int((got == ref).sum())
        total += got.size
    print(f"[5] main path: {n_wavs} x {seconds:g} s WAVs, tree "
          f"{task.tree.num_nodes} nodes, {task.model.num_states} tied "
          f"states; LNAs {t_lna:.3f} s, recognize {t_dec:.3f} s; launches "
          f"{launches}; LNA codes vs plain: max step {steps}, identical "
          f"{same}/{total}", flush=True)
    if steps > 1 or same < 0.99 * total:
        fail("LNA codes of the kernel path are not within one step of the "
             "plain path's")
    return launches, task_argv


def _planted(results, true_words, n=4) -> tuple[int, int]:
    """(words in place, planted words) over the first n utterances."""
    agree = tot = 0
    for b in range(min(n, len(results))):
        ref = [f"w{i}" for i in true_words[b]]
        agree += sum(h == r for h, r in zip(results[b].words, ref))
        tot += len(ref)
    return agree, tot


def phase_decode(device, task, B=128, T=1000, card=""):
    """Dense decode at the bench operating point; planted-word check."""
    from aaltoasr_tpu_torch.decoder.search import SearchConfig
    from aaltoasr_tpu_torch.decoder.search_dense import DenseBeamSearch
    from aaltoasr_tpu_torch.synth import planted_obs, synth_obs
    cfg = SearchConfig(lm_scale=30.0, duration_scale=3.0, num_records=32)
    search = DenseBeamSearch(task.tree, task.fsa, task.model, cfg,
                             device=device)
    plan, true_words = synth_obs(task.model, task.info, B, T)
    g = torch.Generator(device=device).manual_seed(1)
    obs = planted_obs(plan, task.model.num_states, g, device=device)
    n = np.full(B, T)
    res = search.decode_batch(obs, n, lattice=False)      # warm
    agree, tot = _planted(res, true_words)
    best = float("inf")
    for _ in range(3):
        sync(device)
        t0 = time.perf_counter()
        search.decode_batch(obs, n, lattice=False)
        sync(device)
        best = min(best, time.perf_counter() - t0)
    xrt = B * T / 125.0 / best
    print(f"[6] dense decode B={B} T={T}: planted words {agree}/{tot}; best "
          f"of 3 {best:.3f} s = {xrt:.1f}x real time on {card}", flush=True)
    return agree, tot


def _phone_probs(argv, device) -> tuple[dict, float]:
    """`cli.phone_probs` on `argv`, the kernels' counts set to 0 just
    before; returns (their launches in this run, wall s)."""
    from aaltoasr_tpu_torch.cli import phone_probs
    from aaltoasr_tpu_torch.ops.frontend_cuda import mfcc_core
    from aaltoasr_tpu_torch.ops.gmm_cuda import gmm_state_ll
    mfcc_core.launches = 0
    gmm_state_ll.launches = 0
    sync(device)
    t0 = time.perf_counter()
    rc = phone_probs.main(argv)
    sync(device)
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"phone_probs {' '.join(argv)} returned {rc}")
    return ({"mfcc_core": mfcc_core.launches,
             "gmm_state_ll": gmm_state_ll.launches}, wall)


def _code_agreement(got, want, label) -> str:
    """LNA codes [T, S] (int64 arrays, or lists of them): within one
    step and >= 99% identical, else fail."""
    got, want = (np.concatenate([a.ravel() for a in v])
                 if isinstance(v, list) else v.ravel() for v in (got, want))
    if got.shape != want.shape:
        fail(f"{label}: LNA shapes differ")
    steps = int(np.abs(got - want).max())
    same = int((got == want).sum())
    if steps > 1 or same < 0.99 * got.size:
        fail(f"{label}: LNA codes max step {steps}, identical "
             f"{same}/{got.size}")
    return (f"max step {steps}, identical {same}/{got.size} "
            f"({100.0 * same / got.size:.3f}%)")


def _lna_dir(path, n_wavs) -> list:
    return [_read_codes(os.path.join(path, f"u{u}.lna"))
            for u in range(n_wavs)]


def phase_adapt(device, task, workdir, n_wavs=4) -> dict:
    """`phone_probs -S/-C` on the main path's WAVs; returns the kernels'
    launches per fused path."""
    from aaltoasr_tpu_torch.formats import model_io
    from aaltoasr_tpu_torch.formats.feaconf import FeatureConfig
    from aaltoasr_tpu_torch.formats.spkc import SpeakerConfig
    from aaltoasr_tpu_torch.frontend.audio import read_audio
    from aaltoasr_tpu_torch.frontend.generator import FeatureGenerator
    from aaltoasr_tpu_torch.synth import (
        MFCC_CFG, feature_model, model_cmllr_spkc, nearest_clusters,
        norm_stats, speaker_spkc, splice_cfg, vtln_cfg)
    from aaltoasr_tpu_torch.train.gcluster import write_gcl

    def path(name):
        return os.path.join(workdir, name)

    def write(name, text):
        with open(path(name), "w") as f:
            f.write(text)
        return path(name)

    audio = [read_audio(path(f"u{u}.wav"), 16000)[0] for u in range(n_wavs)]

    def normalized(cfg, **items):
        """The configuration closed by a normalization to zero mean and
        unit variance over these WAVs (a feanorm file's mean and scale):
        centered features, as trained systems score them."""
        fg = FeatureGenerator(FeatureConfig.parse(cfg(**items)),
                              device=device)
        return cfg(norm=norm_stats(torch.cat(
            [fg.features(a) for a in audio]).cpu().numpy()), **items)
    recipe = write("adapt.recipe", "".join(
        f"audio={path(f'u{u}.wav')} lna=u{u}.lna "
        f"speaker={SPEAKERS[u % 3]} utterance=u{u}\n" for u in range(n_wavs)))

    def phone_probs(tag, cfg, am, extra, dev=device.type):
        os.makedirs(path(tag))
        launches, wall = _phone_probs(
            ["-b", am, "-c", cfg, "-r", recipe, "-o", path(tag),
             "--device", dev] + extra, device)
        return _lna_dir(path(tag), n_wavs), launches, wall

    configs = {
        "splice_lda": (normalized(splice_cfg),
                       speaker_spkc(SPEAKERS, "lin_transform", dim=39)),
        "vtln_sinc": (normalized(vtln_cfg), speaker_spkc(SPEAKERS, "vtln")),
        "vtln_allpass": (normalized(vtln_cfg, **{"all-pass": 1}),
                         speaker_spkc(SPEAKERS, "vtln")),
    }
    by_path = {}
    for name, (cfg_text, spkc_text) in configs.items():
        cfg = write(f"{name}.cfg", cfg_text)
        spkc = write(f"{name}.spkc", spkc_text)
        fg = FeatureGenerator(FeatureConfig.parse(cfg_text), device=device)
        feats = torch.cat([fg.features(a) for a in audio]).cpu().numpy()
        # peaked posteriors, as a trained model gives (most codes
        # saturate); and, for the card against the CPU below, the CPU
        # parity tests' broad model (their frontends differ in the sixth
        # digit, which the peaked one magnifies at some codes)
        for tag, var_scale in (("", 0.25), ("_broad", 16.0)):
            model_io.write_model(path(f"am_{name}{tag}"), feature_model(
                task.model, feats, var_scale, seed=7))
        fused, launches, wall = phone_probs(
            f"{name}_fused", cfg, path(f"am_{name}"),
            ["-S", spkc, "--fused"])
        plain, plain_launches, plain_wall = phone_probs(
            f"{name}_plain", cfg, path(f"am_{name}"), ["-S", spkc])
        want = {"mfcc_core": n_wavs if name == "splice_lda" else 0,
                "gmm_state_ll": n_wavs}
        if launches != want:
            fail(f"{name}: launches {launches}, expected {want}")
        if any(plain_launches.values()):
            fail(f"{name}: the plain path launched {plain_launches}")
        agree = _code_agreement(fused, plain, name)
        print(f"[7] phone_probs -S {name} --fused: launches "
              f"{launches}; {wall:.3f} s (plain {plain_wall:.3f} s); LNA "
              f"codes vs plain: {agree}", flush=True)
        by_path[name] = launches

    # warp 1.0 with the sinc table: the bins themselves
    warped = FeatureGenerator(FeatureConfig.parse(vtln_cfg()), device=device)
    warped.apply_speaker_config(SpeakerConfig.parse(
        configs["vtln_sinc"][1]).speaker_params(SPEAKERS[1]))
    unwarped = FeatureGenerator(FeatureConfig.parse(MFCC_CFG), device=device)
    a, b = warped.features(audio[0]), unwarped.features(audio[0])
    err = float((a - b).abs().max())
    print(f"[7] vtln warp 1.0 (sinc) vs unwarped features {tuple(b.shape)}: "
          f"max|d| {err:.3e} (rtol 1e-5, atol 1e-4*max)", flush=True)
    if a.shape != b.shape or not _within(a, b, 1e-5,
                                         1e-4 * float(b.abs().max())):
        fail("vtln warp 1.0 does not give the unwarped features")

    # -C on the diagonal model, a model-namespace CMLLR speaker: the card
    # against the CPU, each computing its own features
    cfg, am = path("splice_lda.cfg"), path("am_splice_lda_broad")
    model = model_io.read_model(am)
    write_gcl(path("c.gcl"), nearest_clusters(model.means, 64), 64)
    mllr = write("mllr.spkc", model_cmllr_spkc(
        SPEAKERS, model.dim, model.num_gaussians, classes=4))
    for tag, extra in (("C", ["-S", path("splice_lda.spkc"),
                              "-C", path("c.gcl")]),
                       ("S_model_cmllr", ["-S", mllr])):
        card, launches, wall = phone_probs(f"{tag}_cuda", cfg, am, extra)
        cpu, _, cpu_wall = phone_probs(f"{tag}_cpu", cfg, am, extra, "cpu")
        if any(launches.values()):
            fail(f"-{tag}: the plain path launched {launches}")
        agree = _code_agreement(card, cpu, f"-{tag} card vs CPU")
        print(f"[7] phone_probs -{tag.replace('_', ' ')} (plain path, "
              f"splice + LDA): card {wall:.3f} s, CPU {cpu_wall:.3f} s; LNA "
              f"codes card vs CPU: {agree}", flush=True)
    return by_path


def phase_adapt_full_width(device, n_utts=32, seconds=10.0, G=10000,
                           S=2500, K=8, clusters=256, rounds=8) -> dict:
    """The full-covariance and gated scorers and one model-CMLLR speaker
    switch at the bench scoring model, and the fused scoring batch of
    the MFCC and the splice + LDA configurations."""
    from aaltoasr_tpu_torch.formats.feaconf import FeatureConfig
    from aaltoasr_tpu_torch.formats.spkc import SpeakerConfig
    from aaltoasr_tpu_torch.frontend.generator import FeatureGenerator
    from aaltoasr_tpu_torch.ops.gmm import GmmScorer, quantize_lna_u16
    from aaltoasr_tpu_torch.ops.gmm_cuda import FusedGmmScorer
    from aaltoasr_tpu_torch.synth import (
        MFCC_CFG, cmllr_transforms, feature_model, nearest_clusters,
        norm_stats, random_model, speaker_spkc, splice_cfg)
    from aaltoasr_tpu_torch.train.mllr import apply_model_cmllr
    samples, lens = _noise_batch(device, n_utts, seconds)
    x = _scoring_features(
        FeatureGenerator(FeatureConfig.parse(MFCC_CFG), device=device),
        samples, lens)
    mean, scale = (torch.as_tensor(v, dtype=torch.float32, device=device)
                   for v in norm_stats(x.cpu().numpy()))
    x = ((x - mean) * scale).contiguous()     # a normalization module
    T, D = x.shape
    model = feature_model(random_model(G=G, S=S, D=D, K=K),
                          x.cpu().numpy(), 0.25)
    rng = np.random.default_rng(5)
    transforms = cmllr_transforms(D, 4, rng)
    gauss_class = rng.integers(0, 4, G)
    sync(device)
    t0 = time.perf_counter()
    adapted = apply_model_cmllr(model, transforms, gauss_class)
    full = GmmScorer.from_model(adapted, device=device)
    sync(device)
    switch_s = time.perf_counter() - t0
    assign = nearest_clusters(model.means, clusters)
    dense = GmmScorer.from_model(model, device=device)
    gated = dense.with_clustering(model, assign, clusters, 0.0, 0.1)
    cpu = {"full-cov": GmmScorer.from_model(adapted, device="cpu"),
           "gated": GmmScorer.from_model(model, device="cpu").with_clustering(
               model, assign, clusters, 0.0, 0.1)}
    res = {"switch_s": switch_s}
    Gp = int(full.score_matrix.shape[1])
    # the full-covariance product as it was formed before it moved to
    # float64 (the same code on float32 tables), timed beside it
    full32 = dataclasses.replace(full, score_matrix=full.score_matrix.float(),
                                 score_bias=full.score_bias.float())
    flops = {"full-cov": 2.0 * T * (D * D + D) * Gp,
             "full-cov float32 form": 2.0 * T * (D * D + D) * Gp,
             "gated": 2.0 * T * 2 * D * (Gp + clusters),
             "diagonal": 2.0 * T * 2 * D * Gp}
    kinds = {"full-cov": "float64", "full-cov float32 form": "IEEE float32",
             "gated": "IEEE float32", "diagonal": "IEEE float32"}
    for name, sc in (("full-cov", full), ("full-cov float32 form", full32),
                     ("gated", gated), ("diagonal", dense)):
        out = sc.state_log_likelihoods(x)
        if not bool(torch.isfinite(out[:, :S]).all()):
            fail(f"{name} scorer: non-finite scores at the scoring model")
        del out
        ms = timed_ms(lambda: sc.state_log_likelihoods(x), device, iters=5,
                      warmup=1)
        agree = ""
        if name in cpu:
            got = quantize_lna_u16(sc.lna_log_probs(x[:256])).cpu().long()
            want = quantize_lna_u16(cpu[name].lna_log_probs(x[:256].cpu()))
            agree = "; LNA codes card vs CPU (256 frames): " + \
                _code_agreement(got.numpy(), want.long().numpy(), name)
        print(f"[7] {name} scorer T={T} G={G} (Gp {Gp}) S={S} K={K} D={D}: "
              f"{ms:.3f} ms ({flops[name] * 1e-9:.1f} GFLOP of products in "
              f"{kinds[name]}){agree}", flush=True)
        res[f"{name}_ms"] = ms
    print(f"[7] one model-CMLLR speaker switch at G={G} (4 classes: fold + "
          f"scorer rebuild, host loop): {switch_s:.3f} s", flush=True)

    # the fused scoring batch (fused MFCC + K1 + LNA normalization)
    fused = FusedGmmScorer.from_scorer(dense)
    raw = FeatureGenerator(FeatureConfig.parse(splice_cfg()), device=device)
    splice = FeatureGenerator(FeatureConfig.parse(splice_cfg(norm=norm_stats(
        _scoring_features(raw, samples[:2], lens[:2]).cpu().numpy()))),
        fused_mfcc=True, device=device)
    splice.apply_speaker_config(SpeakerConfig.parse(speaker_spkc(
        SPEAKERS, "lin_transform", dim=D)).speaker_params(SPEAKERS[0]))
    gens = {"mfcc": FeatureGenerator(FeatureConfig.parse(MFCC_CFG),
                                     fused_mfcc=True, device=device),
            "splice_lda": splice}
    times = {name: [] for name in gens}
    for r in range(rounds):
        for name in (list(gens) if r % 2 == 0 else list(gens)[::-1]):
            sync(device)
            t0 = time.perf_counter()
            lp = fused.lna_log_probs(gens[name].features_batch(samples, lens))
            sync(device)
            times[name].append((time.perf_counter() - t0) * 1e3)
            del lp
    for name, ts in times.items():
        res[f"batch_{name}_ms"] = float(np.median(ts[2:]))
    print(f"[7] fused scoring batch ({n_utts} x {seconds:g} s, fused MFCC + "
          f"K1 + LNA normalization, host clock, median of {rounds - 2}): "
          + ", ".join(f"{name} {res[f'batch_{name}_ms']:.3f} ms"
                      for name in gens), flush=True)
    return res


def _profile_steps(search, obs, device, frames=20, warm=5) -> str:
    """Kernel launches a frame and the device-busy share over `frames`
    steps of the exact engine (after `warm` steps), from torch.profiler's
    device events: launches count the kernels (copies and fills apart),
    busy = every event's summed time over the span from the first one's
    start to the last one's end."""
    from torch.profiler import ProfilerActivity, profile
    tok = search._seed_tokens(obs[:, 0], int(search.lm.initial_state()))
    for i in range(warm):
        tok, _ = search._step(tok, obs[:, i + 1], i)
    sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(warm, warm + frames):
            tok, _ = search._step(tok, obs[:, i + 1], i)
        sync(device)
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return "device events: not measured (the profiler saw none)"
    by_name: dict = {}
    for e in dev:
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + e.time_range.end - e.time_range.start)
    copies = sum(e.name.startswith(("Memcpy", "Memset")) for e in dev)
    busy = sum(by_name.values())
    span = (max(e.time_range.end for e in dev)
            - min(e.time_range.start for e in dev))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return (f"{(len(dev) - copies) / frames:.1f} kernel launches and "
            f"{copies / frames:.1f} copies or fills a frame, device busy "
            f"{100.0 * busy / span:.1f}% of {span / frames / 1e3:.3f} ms a "
            f"frame, {busy / frames / 1e3:.3f} ms of device time a frame "
            f"(profiler, {frames} frames); most device time: "
            + "; ".join(f"{100.0 * v / busy:.1f}% {k[:60]}" for k, v in top))


def _cli(main, argv) -> tuple[str, str, float]:
    """(stdout, stderr, wall s) of one CLI run; fails unless it returns
    0."""
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    if rc not in (0, None):
        fail(f"{main.__module__} {' '.join(argv)} returned {rc}")
    return out.getvalue(), err.getvalue(), time.perf_counter() - t0


def _recognize(argv) -> tuple[list, str, float]:
    """`cli.recognize` on `argv`: (its result lines, its stderr, wall s);
    fails unless it returns 0 through the exact engine."""
    from aaltoasr_tpu_torch.cli import recognize
    out, err, wall = _cli(recognize.main, argv)
    if "-> exact" not in err:
        fail(f"recognize {' '.join(argv)} did not run the exact engine")
    lines = [ln for ln in out.splitlines() if ln.endswith(")")]
    return lines, err.strip(), wall


def phase_exact(device, task, recognize_argv, card="", B=128, T=1000,
                B_default=4, n_cmp=2):
    """[8] The exact engine: (a) at the bench's cross-word point
    (`exact_crossword_trigram_xrt`: W=512, E=32, overflow 128, prewalk
    256, re-entry 8 + 8) on B planted utterances of T frames, the card
    against the CPU on the first n_cmp; (b) at the default knobs
    (W=1024, E=128) on the first B_default of them; (c) `recognize` at
    its default engine on the first n_cmp written as LNAs, on the card,
    and on the first one on the CPU."""
    from aaltoasr_tpu_torch.decoder.search import BeamSearch, SearchConfig
    from aaltoasr_tpu_torch.formats.lna import write_lna
    from aaltoasr_tpu_torch.synth import planted_obs, synth_obs
    plan, true_words = synth_obs(task.model, task.info, B, T)
    g = torch.Generator(device=device).manual_seed(1)
    obs = planted_obs(plan, task.model.num_states, g, device=device)
    n = np.full(B, T)
    cfg = SearchConfig(lm_scale=30.0, duration_scale=3.0, num_tokens=512,
                       num_records=32, overflow_tokens=128, we_prewalk=256,
                       reentry_records=8, reentry_prewalk=8)
    search = BeamSearch(task.tree, task.fsa, task.model, cfg, device=device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    res = search.decode_batch(obs, n, lattice=False)          # warm
    agree, tot = _planted(res, true_words)
    best = float("inf")
    for _ in range(3):
        sync(device)
        t0 = time.perf_counter()
        search.decode_batch(obs, n, lattice=False)
        sync(device)
        best = min(best, time.perf_counter() - t0)
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if device.type == "cuda" else float("nan"))
    print(f"[8] exact decode, bench cross-word point (W=512, E=32, overflow "
          f"128, prewalk 256, re-entry 8 + 8), B={B} T={T}: planted words "
          f"{agree}/{tot}; best of 3 {best:.3f} s = "
          f"{B * T / 125.0 / best:.1f}x real time, {(T - 1) / best:.1f} "
          f"frames/s ({B * (T - 1) / best:.0f} utterance-frames/s), peak "
          f"{peak:.2f} GiB on {card}", flush=True)
    print("[8] exact step at that point: "
          f"{_profile_steps(search, obs, device)}", flush=True)
    if agree < tot - 1:
        fail(f"exact planted-word check {agree}/{tot} below {tot - 1}/{tot}")
    # the card against the CPU, records included
    cmp = (obs[:n_cmp], n[:n_cmp])
    card_res = search.decode_batch(*cmp)
    cpu_res = BeamSearch(task.tree, task.fsa, task.model, cfg,
                         device="cpu").decode_batch(cmp[0].cpu(), cmp[1])
    for c, h in zip(card_res, cpu_res):
        same = (c.words == h.words and c.final_word == h.final_word
                and np.array_equal(c.rec_words, h.rec_words)
                and np.array_equal(c.rec_prevs, h.rec_prevs))
        close = all(np.allclose(a, b, rtol=1e-5, atol=1e-3) for a, b in (
            (c.log_prob, h.log_prob), (c.rec_ams, h.rec_ams),
            (c.rec_lmss, h.rec_lmss)))
        if not (same and close):
            fail("exact decode on the card differs from the CPU's")
    print(f"[8] exact decode, card against CPU on {n_cmp} utterances: words, "
          f"record words and pointers identical, scores within rtol 1e-5 "
          f"atol 1e-3 (log-probs {card_res[0].log_prob:.4f} / "
          f"{cpu_res[0].log_prob:.4f}, ...)", flush=True)

    search = BeamSearch(task.tree, task.fsa, task.model,
                        SearchConfig(lm_scale=30.0, duration_scale=3.0),
                        device=device)
    sub, nd = obs[:B_default], n[:B_default]
    sync(device)
    t0 = time.perf_counter()
    res = search.decode_batch(sub, nd, lattice=False)
    sync(device)
    wall = time.perf_counter() - t0
    agree_d, tot_d = _planted(res, true_words)
    print(f"[8] exact decode, default knobs (W=1024, E=128), B={B_default} "
          f"T={T}, one run: planted words {agree_d}/{tot_d}; {wall:.3f} s = "
          f"{B_default * T / 125.0 / wall:.1f}x real time, "
          f"{1e3 * wall / (T - 1):.3f} ms a frame", flush=True)
    if agree_d < tot_d - 1:
        fail(f"exact planted-word check at the default knobs {agree_d}/"
             f"{tot_d} below {tot_d - 1}/{tot_d}")

    # recognize on planted utterances written as LNAs (the frame's
    # log-softmax: a per-frame shift, so the same best path)
    argv = list(recognize_argv)
    pdir = os.path.join(argv[argv.index("-w") + 1], "planted")
    os.makedirs(os.path.join(pdir, "lna"))
    for u in range(n_cmp):
        write_lna(os.path.join(pdir, "lna", f"p{u}.lna"), torch.log_softmax(
            obs[u, :n[u]], -1).cpu().numpy(), 2)
    argv[argv.index("-w") + 1] = pdir
    lines = {}
    for side, dev, count in (("card", device.type, n_cmp), ("cpu", "cpu", 1)):
        argv[argv.index("-r") + 1] = recipe = os.path.join(
            pdir, f"{side}.recipe")
        with open(recipe, "w") as f:
            f.write("".join(f"audio={pdir}/p{u}.wav lna=p{u}.lna "
                            f"utterance=p{u}\n" for u in range(count)))
        lines[side], engine, wall = _recognize(argv + ["--device", dev])
        print(f"[8] recognize ({engine}) --device {dev}: "
              f"{len(lines[side])} planted utterances in {wall:.3f} s",
              flush=True)
    for ln in lines["card"]:
        print(f"[8]   {ln}", flush=True)
    words = [ln.rsplit(" (", 1)[0].split() for ln in lines["card"]]
    agree_r = sum(h == f"w{r}" for b in range(n_cmp)
                  for h, r in zip(words[b], true_words[b]))
    tot_r = sum(len(true_words[b]) for b in range(n_cmp))
    same = lines["cpu"] == lines["card"][:1]
    print(f"[8] recognize: planted words {agree_r}/{tot_r}; the first "
          f"utterance's line, card against CPU: "
          f"{'identical' if same else 'DIFFERENT'}", flush=True)
    if agree_r < tot_r - 1:
        fail(f"recognize planted-word check {agree_r}/{tot_r} below "
             f"{tot_r - 1}/{tot_r}")
    if len(lines["card"]) != n_cmp or not same:
        fail(f"recognize lines, card against CPU: {lines}")


def _bf16_step(x: np.ndarray) -> np.ndarray:
    """The spacing of bfloat16 values (8 significant bits) at |x|."""
    a = np.abs(x.astype(np.float64))
    e = np.floor(np.log2(np.where(a > 0, a, 1.0)))
    return np.where(a > 0, 2.0 ** (e - 7), 0.0)


def _slf(graph) -> str:
    out = io.StringIO()
    graph.write_slf(out)
    return out.getvalue()


def _slf_diff(want: str, got: str) -> str:
    """'' when two SLF texts parse to the same node frames and arc keys
    (S, E, W) in the same order, arc scores within atol 2e-3."""
    from aaltoasr_tpu_torch.decoder.slf import SlfLattice
    a, b = SlfLattice.read(want), SlfLattice.read(got)
    if a.nodes != b.nodes or (a.start, a.end) != (b.start, b.end):
        return "SLF nodes differ"
    if [(x["S"], x["E"], x["W"]) for x in a.arcs] != [
            (x["S"], x["E"], x["W"]) for x in b.arcs]:
        return "SLF arcs differ"
    d = max((abs(x[k] - y[k]) for x, y in zip(a.arcs, b.arcs)
             for k in ("a", "l")), default=0.0)
    return f"SLF arc scores differ by {d:.3g}" if d > 2e-3 else ""


def _lattice_diff(card, cpu) -> str:
    """'' when two results agree as phase [9] (c) asks: record words and
    pointers identical, scores within rtol 1e-5 atol 1e-3; the SLF as
    `_slf_diff`; nbest(5) word sequences identical; confusion-network
    confidences within 1e-3."""
    from aaltoasr_tpu_torch.decoder.wordgraph import confusion_network
    if card.words != cpu.words or card.final_word != cpu.final_word:
        return "words differ"
    if not (np.array_equal(card.rec_words, cpu.rec_words)
            and np.array_equal(card.rec_prevs, cpu.rec_prevs)):
        return "record words or pointers differ"
    if not all(np.allclose(a, b, rtol=1e-5, atol=1e-3) for a, b in (
            (card.rec_ams, cpu.rec_ams), (card.rec_lmss, cpu.rec_lmss),
            (card.log_prob, cpu.log_prob))):
        return "record scores differ"
    g_card, g_cpu = card.word_graph(), cpu.word_graph()
    diff = _slf_diff(_slf(g_cpu), _slf(g_card))
    if diff:
        return diff
    if [w for w, _ in g_card.nbest(5)] != [w for w, _ in g_cpu.nbest(5)]:
        return "nbest(5) word sequences differ"
    cn_card, cn_cpu = confusion_network(g_card), confusion_network(g_cpu)
    if [w for w, _, _ in cn_card] != [w for w, _, _ in cn_cpu] or any(
            abs(a[1] - b[1]) > 1e-3 for a, b in zip(cn_card, cn_cpu)):
        return "confusion-network confidences differ"
    return ""


def _graphs(results, true_words) -> str:
    """`word_graph()` host ms per utterance (median, max), node and arc
    counts, and nbest(1)'s planted words in place, over `results`."""
    ms, nodes, arcs, agree, tot = [], [], [], 0, 0
    for res, true in zip(results, true_words):
        t0 = time.perf_counter()
        g = res.word_graph()
        ms.append(1e3 * (time.perf_counter() - t0))
        nodes.append(len(g.nodes))
        arcs.append(len(g.arcs))
        best = g.nbest(1)[0][0]
        agree += sum(h == f"w{r}" for h, r in zip(best, true))
        tot += len(true)
    return (f"word_graph() host ms per utterance median {np.median(ms):.1f} "
            f"max {max(ms):.1f} over {len(ms)}; nodes median "
            f"{int(np.median(nodes))} max {max(nodes)}, arcs median "
            f"{int(np.median(arcs))} max {max(arcs)}; nbest(1) planted words "
            f"{agree}/{tot}")


def _fetched(B, T, E, lattice, half=False) -> int:
    """Bytes a decode of B utterances of T frames brings to the host:
    int64 (word, pointer) pairs for every record slot, with ``lattice``
    the (am, lm) scores too (2 bytes each with ``half``, else 4), and
    five 8-byte scalars an utterance."""
    score = (4 if half else 8) if lattice else 0
    return B * (T - 1) * E * (16 + score) + 40 * B


# the records and finals a CPU decode sends back to the parent process
_RESULT_FIELDS = ("final_ptr", "log_prob", "final_am", "final_lms",
                  "rec_words", "rec_prevs", "rec_ams", "rec_lmss",
                  "final_word")


# the tasks a worker process has built, by their `synth_task` arguments
_TASKS: dict = {}


def _second_lm(task):
    """The second member of phase 10's interpolated LM: a uniform unigram
    over the task's vocabulary."""
    from aaltoasr_tpu_torch.formats.arpa import ArpaLM
    V = len(task.arpa.vocab)
    return ArpaLM(order=1, vocab=list(task.arpa.vocab),
                  word_index=dict(task.arpa.word_index),
                  ngrams=[{}, {(i,): (float(np.log(1.0 / V)), 0.0)
                               for i in range(V)}])


def _word_classes_text(task) -> str:
    """Phase 10's word classes: the first half of the words each its own
    class at membership 0.5, in the second half each odd word a member
    (0.4) of the class named by the even word before it (0.6)."""
    words = task.info["words"]
    half = len(words) // 2
    lines = [f"{w} 0.5 {w}" for w in words[:half]]
    for i in range(half, len(words) - 1, 2):
        lines += [f"{words[i]} 0.6 {words[i]}",
                  f"{words[i]} 0.4 {words[i + 1]}"]
    return "\n".join(lines) + "\n"


def _option_search(task, fields, extra, device):
    """`BeamSearch` of ``task`` with config ``fields``; ``extra`` "inter"
    interpolates the task's LM (0.8) with `_second_lm` (0.2), "classes"
    decodes with `_word_classes_text`."""
    from aaltoasr_tpu_torch.decoder.classes import WordClasses
    from aaltoasr_tpu_torch.decoder.ngram import InterNGramFsa
    from aaltoasr_tpu_torch.decoder.search import BeamSearch, SearchConfig
    lm, wc = task.fsa, None
    if extra == "inter":
        lm = InterNGramFsa.from_arpas([task.arpa, _second_lm(task)],
                                      [0.8, 0.2])
    elif extra == "classes":
        wc = WordClasses.read(_word_classes_text(task))
    return BeamSearch(task.tree, lm, task.model, SearchConfig(**fields),
                      word_classes=wc, device=device)


def _cpu_job(kind: str, args):
    """Phases [9] and [10]'s CPU side, in a worker process of one thread:
    a lattice decode (``kind`` "dense" or "exact", args = (`synth_task`
    arguments, config fields, [1, T, S] observations[, the exact
    engine's `_option_search` extra])) returning the result's fields, or
    a CLI run (``kind`` its module, args = argv) returning `_cli`'s
    (stdout, stderr, wall s)."""
    torch.set_num_threads(1)
    if kind in ("dense", "exact"):
        from aaltoasr_tpu_torch.decoder.search import SearchConfig
        from aaltoasr_tpu_torch.decoder.search_dense import DenseBeamSearch
        from aaltoasr_tpu_torch.synth import synth_task
        task_args, fields, obs, *extra = args
        key = tuple(sorted(task_args.items()))
        if key not in _TASKS:
            _TASKS[key] = synth_task(**task_args)
        task = _TASKS[key]
        if kind == "dense":
            search = DenseBeamSearch(task.tree, task.fsa, task.model,
                                     SearchConfig(**fields), device="cpu")
        else:
            search = _option_search(task, fields, (extra or [None])[0],
                                    "cpu")
        res = search.decode_batch(obs, [obs.shape[1]], lattice=True)[0]
        return {f: getattr(res, f) for f in _RESULT_FIELDS}
    import importlib
    return _cli(importlib.import_module(kind).main, args)


def phase_lattice(device, task, recognize_argv, card="", B=128, T=1000,
                  n_exact=2, task_args=TASK):
    """[9] Lattices: (a) the dense engine at the `decode_xrt` point with
    lattice=False, lattice=True and bfloat16 records; (b) the exact
    engine at phase 8's bench cross-word point on n_exact utterances,
    lattice=False and True; (d) `recognize --lattices --nbest 3
    --confidence` with either engine on phase 8's planted LNAs,
    `decode --lattice-grammar` of the first one's SLF, and
    `lattice_rescore --best` of that SLF with the task's ARPA.  The CPU
    side, (c) the first utterance of (a) and of (b) and the first of (d)
    (its recognize runs and the decode), runs in worker processes beside
    (d)'s card runs, after the timed runs of (a) and (b); they build
    ``task`` anew from ``task_args``."""
    import dataclasses
    import multiprocessing
    import shutil
    from concurrent.futures import ProcessPoolExecutor
    from aaltoasr_tpu_torch.cli import decode, lattice_rescore, recognize
    from aaltoasr_tpu_torch.decoder.search import (
        BeamSearch, DecodeResult, SearchConfig)
    from aaltoasr_tpu_torch.decoder.search_dense import DenseBeamSearch, fma
    from aaltoasr_tpu_torch.synth import planted_obs, synth_obs
    t_phase = time.perf_counter()
    # the dense step's x + s * y must round once on the card as on the
    # CPU (where XLA, the reference, fuses it)
    g = torch.Generator(device=device).manual_seed(2)
    x, y = (torch.randn(10**6, generator=g, device=device) * 30
            for _ in range(2))
    scale = 30.0 / 2.302585092994046
    want = (x.double() + torch.tensor(scale, dtype=torch.float32).double()
            * y.double()).float()
    if not torch.equal(fma(x, y, scale), want):
        fail("search_dense.fma is not a fused multiply-add on the card")
    twice = float((x + scale * y != want).float().mean())
    print(f"[9] search_dense.fma on 10^6 values: identical to a fused "
          f"multiply-add (float64 then float32); x + s * y rounded twice "
          f"differs on {100.0 * twice:.1f}% of them", flush=True)
    plan, true_words = synth_obs(task.model, task.info, B, T)
    g = torch.Generator(device=device).manual_seed(1)
    obs = planted_obs(plan, task.model.num_states, g, device=device)
    n = np.full(B, T)

    def timed(search, o, nn, lattice):
        sync(device)
        t0 = time.perf_counter()
        res = search.decode_batch(o, nn, lattice=lattice)
        sync(device)
        return res, time.perf_counter() - t0

    # (a) the dense engine
    cfg_dense = SearchConfig(lm_scale=30.0, duration_scale=3.0,
                             num_records=32)
    runs = {}
    for label, c, lattice in (
            ("1-best", cfg_dense, False), ("lattice", cfg_dense, True),
            ("lattice bf16",
             dataclasses.replace(cfg_dense, records_half=True), True)):
        search = DenseBeamSearch(task.tree, task.fsa, task.model, c,
                                 device=device)
        runs[label] = timed(search, obs, n, lattice)
        print(f"[9] dense B={B} T={T} {label}: {runs[label][1]:.3f} s, "
              f"fetched {_fetched(B, T, 32, lattice, c.records_half)} bytes"
              f" on {card}", flush=True)
    words = [[r.words for r in runs[k][0]] for k in runs]
    if not words[0] == words[1] == words[2]:
        fail("dense words differ between lattice=False, True and bf16")
    dense, half = runs["lattice"][0], runs["lattice bf16"][0]
    steps = 0.0
    for f, h in zip(dense, half):
        if not (np.array_equal(f.rec_words, h.rec_words)
                and np.array_equal(f.rec_prevs, h.rec_prevs)):
            fail("bf16 record words or pointers differ")
        for a, b in ((f.rec_ams, h.rec_ams), (f.rec_lmss, h.rec_lmss)):
            step = _bf16_step(a)
            err = np.abs(b.astype(np.float64) - a)
            if (err > step).any():
                fail("bf16 records are not within one bfloat16 step")
            steps = max(steps, float((err / np.where(step > 0, step, 1)
                                      ).max()))
    print(f"[9] dense: words identical in all three; bf16 records within "
          f"{steps:.3f} bfloat16 steps of float32's; "
          f"{_graphs(dense, true_words)}", flush=True)

    # (b) the exact engine at phase 8's bench cross-word point
    cfg_exact = SearchConfig(lm_scale=30.0, duration_scale=3.0,
                             num_tokens=512, num_records=32,
                             overflow_tokens=128, we_prewalk=256,
                             reentry_records=8, reentry_prewalk=8)
    search = BeamSearch(task.tree, task.fsa, task.model, cfg_exact,
                        device=device)
    sub = (obs[:n_exact], n[:n_exact])
    fast, t_fast = timed(search, *sub, False)
    exact, t_full = timed(search, *sub, True)
    if [r.words for r in fast] != [r.words for r in exact]:
        fail("exact words differ between lattice=False and True")
    print(f"[9] exact B={n_exact} T={T} (W=512, E=32, overflow 128, prewalk "
          f"256, re-entry 8 + 8): 1-best {t_fast:.3f} s, lattice "
          f"{t_full:.3f} s, fetched {_fetched(n_exact, T, 32, False)} and "
          f"{_fetched(n_exact, T, 32, True)} bytes; "
          f"{_graphs(exact, true_words)}", flush=True)

    # (d) the CLIs on phase 8's planted LNAs: each engine on the card,
    # the first utterance on the CPU
    argv = list(recognize_argv)
    planted = os.path.join(argv[argv.index("-w") + 1], "planted")
    root = os.path.join(planted, "lattice")

    def recognize_argv_for(engine, side, count):
        work = os.path.join(root, f"{engine}-{side}")
        os.makedirs(os.path.join(work, "lna"))
        with open(os.path.join(work, "r.recipe"), "w") as f:
            for u in range(count):
                shutil.copy(os.path.join(planted, "lna", f"p{u}.lna"),
                            os.path.join(work, "lna"))
                f.write(f"audio={work}/p{u}.wav lna=p{u}.lna "
                        f"utterance=p{u}\n")
        a = list(argv)
        a[a.index("-w") + 1] = work
        a[a.index("-r") + 1] = os.path.join(work, "r.recipe")
        return work, a + ["--engine", engine, "--lattices", "--nbest", "3",
                          "--confidence", "--device", dev_of[side]]

    def decode_argv(side, slf):
        work = os.path.join(root, f"decode-{side}")
        os.makedirs(work)
        with open(os.path.join(work, "r.recipe"), "w") as f:
            f.write(f"lna={planted}/lna/p0.lna utterance=p0\n")
        return ["-p", argv[argv.index("-b") + 1] + ".ph",
                "-d", argv[argv.index("--dur") + 1],
                "-l", argv[argv.index("-l") + 1],
                "-r", os.path.join(work, "r.recipe"),
                "--lattice-grammar", slf, "--device", dev_of[side]]

    dev_of = {"card": device.type, "cpu": "cpu"}
    out, work = {}, {}
    first = obs[:1].cpu().numpy()
    jobs = {"dense": ("dense", (task_args, dataclasses.asdict(cfg_dense),
                                first)),
            "exact": ("exact", (task_args, dataclasses.asdict(cfg_exact),
                                first))}
    for engine in ("exact", "dense"):
        work[engine, "cpu"], a = recognize_argv_for(engine, "cpu", 1)
        jobs[engine, "cpu"] = ("aaltoasr_tpu_torch.cli.recognize", a)
    slf = os.path.join(root, "p0.slf")
    t_cpu = time.perf_counter()
    with ProcessPoolExecutor(
            len(jobs) + 1,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {k: pool.submit(_cpu_job, *v) for k, v in jobs.items()}
        work["exact", "card"], a = recognize_argv_for("exact", "card",
                                                      n_exact)
        out["exact", "card"] = _cli(recognize.main, a)
        shutil.copy(os.path.join(work["exact", "card"], "lna",
                                 "p0.lna.slf"), slf)
        futures["decode"] = pool.submit(
            _cpu_job, "aaltoasr_tpu_torch.cli.decode",
            decode_argv("cpu", slf))
        work["dense", "card"], a = recognize_argv_for("dense", "card",
                                                      n_exact)
        out["dense", "card"] = _cli(recognize.main, a)
        out["decode", "card"] = _cli(decode.main, decode_argv("card", slf))
        t_card = time.perf_counter() - t_cpu
        cpu = {k: f.result() for k, f in futures.items()}
    t_cpu = time.perf_counter() - t_cpu
    out.update({k: cpu[k] for k in (("exact", "cpu"), ("dense", "cpu"))})
    out["decode", "cpu"] = cpu["decode"]

    # (c) the first utterance of (a) and of (b), card against CPU
    for name, card_res in (("dense", dense[0]), ("exact", exact[0])):
        host = DecodeResult(search=card_res.search, **cpu[name])
        diff = _lattice_diff(card_res, host)
        if diff:
            fail(f"{name} lattice, card against CPU: {diff}")
        print(f"[9] {name}, card against CPU on the first utterance: "
              "records, SLF, nbest(5) and confidences agree", flush=True)

    for engine in ("exact", "dense"):
        for side, count in (("card", n_exact), ("cpu", 1)):
            print(f"[9] recognize --engine {engine} --lattices --nbest 3 "
                  f"--confidence --device {dev_of[side]}: {count} planted "
                  f"utterances in {out[engine, side][2]:.3f} s", flush=True)
        for ln in out[engine, "card"][0].splitlines():
            print(f"[9]   {ln}", flush=True)
        best = [[ln for ln in out[engine, s][0].splitlines()
                 if not ln.startswith(" ")] for s in ("card", "cpu")]
        if len(best[0]) != n_exact or best[1] != best[0][:1]:
            fail(f"recognize --engine {engine} lattice lines, card against "
                 f"CPU: {best}")
        slfs = [open(os.path.join(work[engine, s], "lna", "p0.lna.slf")
                     ).read() for s in ("cpu", "card")]
        diff = _slf_diff(*slfs)
        if diff:
            fail(f"recognize --engine {engine} p0.lna.slf, card against "
                 f"CPU: {diff}")
    print("[9] recognize: 1-best lines identical and p0.lna.slf alike, card "
          "against CPU, for both engines", flush=True)
    lines = {s: out["decode", s][0].strip() for s in ("card", "cpu")}
    for s in ("card", "cpu"):
        print(f"[9] decode --lattice-grammar p0.slf --device {dev_of[s]}: "
              f"{out['decode', s][2]:.3f} s: {lines[s]}", flush=True)
    if lines["cpu"] != lines["card"] or not lines["cpu"]:
        fail(f"decode --lattice-grammar, card against CPU: {lines}")
    text, _, wall = _cli(lattice_rescore.main, [
        "-l", argv[argv.index("-n") + 1], "--best", slf])
    print(f"[9] lattice_rescore --best p0.slf with the task's ARPA: "
          f"{1e3 * wall:.1f} ms: {text.strip()}", flush=True)
    print(f"[9] the CPU side ({len(futures)} worker processes, one thread "
          f"each) took {t_cpu:.1f} s beside {t_card:.1f} s of card runs; "
          f"phase 9 took {time.perf_counter() - t_phase:.1f} s on {card}",
          flush=True)


# phase 10's options on top of phase 8's bench cross-word point
BENCH_POINT = dict(lm_scale=30.0, duration_scale=3.0, num_tokens=512,
                   num_records=32, overflow_tokens=128, we_prewalk=256,
                   reentry_records=8, reentry_prewalk=8)
STREAM_OPTIONS = {
    "lookahead 3": ({"lm_lookahead": 3}, None),
    "reentry_topk 4": ({"reentry_topk": 4}, None),
    "reentry_preselect 256": ({"reentry_preselect": 256}, None),
    "eq_depth_beam 200": ({"eq_depth_beam": 200.0}, None),
    "eq_word_count_beam 200": ({"eq_word_count_beam": 200.0}, None),
    "fan_in_beam 200": ({"fan_in_beam": 200.0}, None),
    "fan_out_beam 200": ({"fan_out_beam": 200.0}, None),
    "tp_state_beam 100": ({"tp_state_beam": 100.0}, None),
    "interpolated LM (2 members)": ({}, "inter"),
    "word classes": ({}, "classes"),
}


def _block_kernels(device, task, samples, block):
    """K1 and K2 at the shapes one `decode_stream` block gives them: K2
    on the block's frames with the feature DAG's context, K1 on its
    features against the task's model; each against its plain version."""
    from aaltoasr_tpu_torch.formats.feaconf import FeatureConfig
    from aaltoasr_tpu_torch.frontend.generator import FeatureGenerator
    from aaltoasr_tpu_torch.ops import frontend_cuda as FC
    from aaltoasr_tpu_torch.synth import MFCC_CFG
    fg = FeatureGenerator(FeatureConfig.parse(MFCC_CFG), device=device)
    x = torch.as_tensor(samples, dtype=torch.float32, device=device)
    nl, nr = fg.need["fft"]
    n = torch.full((1,), fg.num_frames(x.shape[0]), device=device)
    frames = fg._base_frames(x[None], n, nl, block, nr)
    frames = frames.reshape(-1, frames.shape[-1]).contiguous()
    args = (frames, fg.ops["fft"].table("basis", device),
            fg.ops["mel"].table("weights", device),
            fg.ops["dct"].table("matrix", device))
    err2, ok = _mfcc_check(args)
    if not ok:
        fail("mfcc_core disagrees with its plain version at the block shape")
    T2, W = frames.shape
    k2 = {"max_abs_err": err2,
          "ms": graph_ms(lambda: FC.mfcc_core(*args), device, iters=100),
          "plain_ms": graph_ms(lambda: FC.reference_core(*args), device,
                               iters=100),
          "library_ms": None}
    C = args[3].shape[1]
    k2["bound_ms"], k2["bound_by"] = bound(2.0 * T2 * W * args[1].shape[1],
                                           4.0 * T2 * (W + C + 1))
    print(f"[10] mfcc_core at the block shape ({T2}, {W}) frames: max|d| "
          f"{err2:.3e}; kernel {k2['ms']:.4f} ms, plain "
          f"{k2['plain_ms']:.4f} ms, bound {k2['bound_ms']:.4f} ms by "
          f"{k2['bound_by']}", flush=True)
    feats = fg.features_range(x, 0, block).contiguous()
    err1, ms1, plain1, _mm, b1 = _gmm_shape(device, feats, task.model,
                                            "at the block shape", tag="[10]")
    k1 = {"max_abs_err": err1, "ms": ms1, "plain_ms": plain1,
          "bound_ms": b1[0], "bound_by": b1[1], "library_ms": None}
    return k2, k1


def phase_stream(device, task, recognize_argv, card="", T=1000,
                 n_stream=2, block=32, T_opt=500, B_opt=4, task_args=TASK):
    """[10] Streaming and the rest of the exact engine's options (see the
    module docstring).  The CPU side, `decode_stream` of the first WAV
    and the first utterance of each option, runs in spawned worker
    processes (one thread each) from the start of the phase."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from aaltoasr_tpu_torch.cli import decode_stream
    from aaltoasr_tpu_torch.decoder.search import (
        BeamSearch, DecodeResult, SearchConfig, StreamingDecoder)
    from aaltoasr_tpu_torch.frontend.audio import read_audio
    from aaltoasr_tpu_torch.ops.frontend_cuda import mfcc_core
    from aaltoasr_tpu_torch.ops.gmm_cuda import gmm_state_ll
    from aaltoasr_tpu_torch.synth import planted_obs, synth_obs
    from aaltoasr_tpu_torch.formats import model_io
    from aaltoasr_tpu_torch.formats.feaconf import FeatureConfig
    from aaltoasr_tpu_torch.frontend.generator import FeatureGenerator
    from aaltoasr_tpu_torch.synth import feature_model
    t_phase = time.perf_counter()
    argv = list(recognize_argv)
    work = os.path.join(argv[argv.index("-w") + 1], "stream")
    os.makedirs(work)
    cfg = FeatureConfig.load(argv[argv.index("-c") + 1])
    plain_fg = FeatureGenerator(cfg, device=device)
    raws, feats = [], []
    for u in range(n_stream):
        samples, _ = read_audio(os.path.join(
            os.path.dirname(argv[argv.index("-r") + 1]), f"u{u}.wav"), 16000)
        raws.append(os.path.join(work, f"u{u}.raw"))
        np.asarray(samples).astype("<i2").tofile(raws[-1])
        feats.append(plain_fg.features(samples).cpu().numpy())
    # the task's model with its Gaussians placed on these WAVs' features
    # (noise audio) and no duration model, so that the stream decodes to
    # words (with the task's model, or with durations, the 1-best of
    # noise holds no word or one)
    am = os.path.join(work, "am")
    model_io.write_model(am, feature_model(task.model, np.concatenate(feats),
                                           0.25))
    stream_argv = ["-b", am, "-c", argv[argv.index("-c") + 1],
                   "-l", argv[argv.index("-l") + 1],
                   "-n", argv[argv.index("-n") + 1]]
    plan, true_opt = synth_obs(task.model, task.info, B_opt, T_opt, seed=3)
    g = torch.Generator(device=device).manual_seed(3)
    obs_opt = planted_obs(plan, task.model.num_states, g, device=device)
    n_opt = np.full(B_opt, T_opt)
    pool = ProcessPoolExecutor(
        6, mp_context=multiprocessing.get_context("spawn"))
    cpu = {"stream": pool.submit(
        _cpu_job, "aaltoasr_tpu_torch.cli.decode_stream",
        stream_argv + ["--device", "cpu", raws[0]])}
    first = obs_opt[:1].cpu().numpy()
    for name, (fields, extra) in STREAM_OPTIONS.items():
        cpu[name] = pool.submit(_cpu_job, "exact", (
            task_args, {**BENCH_POINT, **fields}, first, extra))

    # (a) phase 8's first planted utterances pushed in blocks
    plan, true_words = synth_obs(task.model, task.info, 128, T)
    g = torch.Generator(device=device).manual_seed(1)
    obs = planted_obs(plan, task.model.num_states, g, device=device)
    obs = obs[:n_stream].clone()
    search = BeamSearch(task.tree, task.fsa, task.model,
                        SearchConfig(lm_scale=30.0, duration_scale=3.0),
                        device=device)
    off = search.decode_batch(obs, np.full(n_stream, T), lattice=False)
    block_ms, partial_ms, result_ms = [], [], []
    for u in range(n_stream):
        sd = StreamingDecoder(search)
        for lo in range(0, T, block):
            sync(device)
            t0 = time.perf_counter()
            sd.push_frames(obs[u, lo:lo + block])
            sync(device)
            block_ms.append(1e3 * (time.perf_counter() - t0))
            if (lo + block) % (2 * block) == 0:
                t0 = time.perf_counter()
                words = sd.partial()
                partial_ms.append(1e3 * (time.perf_counter() - t0))
                if words != sd.result().words:
                    fail(f"stream {u} at frame {sd.frame}: partial() "
                         f"differs from result().words")
        t0 = time.perf_counter()
        res = sd.result()
        result_ms.append(1e3 * (time.perf_counter() - t0))
        if res.words != off[u].words:
            fail(f"stream {u}: words differ from BeamSearch.decode_batch")
    agree, tot = _planted(off, true_words, n=n_stream)
    audio_ms = block * 8.0
    print(f"[10] StreamingDecoder, default knobs (W=1024, E=128), "
          f"{n_stream} planted utterances of {T} frames in {block}-frame "
          f"blocks: words identical to BeamSearch.decode_batch (planted "
          f"words {agree}/{tot}), partial() == result().words every "
          f"{2 * block} frames; ms per block median "
          f"{np.median(block_ms):.2f} max {max(block_ms):.2f} ("
          f"{audio_ms / np.median(block_ms):.2f}x real time, "
          f"{np.median(block_ms) / block:.3f} ms a frame); partial() ms "
          f"median {np.median(partial_ms):.2f} max {max(partial_ms):.2f}; "
          f"result() ms {', '.join(f'{v:.2f}' for v in result_ms)} on "
          f"{card}", flush=True)
    del obs

    # (b) decode_stream on the WAVs as raw s16le, the kernels counted
    blocks = [0]
    push = StreamingDecoder.push_frames

    def counted(self, log_probs):
        blocks[0] += 1
        return push(self, log_probs)

    StreamingDecoder.push_frames = counted
    mfcc_core.launches = 0
    gmm_state_ll.launches = 0
    lines, secs = [], 0.0
    t_card = 0.0
    try:
        for raw in raws:
            text, err, wall = _cli(decode_stream.main, stream_argv + [
                "--device", device.type, raw])
            lines.append(text.strip())
            t_card += wall
            secs += os.path.getsize(raw) / 2 / 16000
    finally:
        StreamingDecoder.push_frames = push
    launches = {"mfcc_core": mfcc_core.launches,
                "gmm_state_ll": gmm_state_ll.launches}
    print(f"[10] decode_stream --device {device.type} on {len(raws)} WAVs "
          f"as raw "
          f"s16le ({secs:.1f} s of audio): {t_card:.3f} s wall = "
          f"{secs / t_card:.2f}x real time; {blocks[0]} blocks; launches "
          f"{launches} ({launches['mfcc_core'] / blocks[0]:.2f} K2, "
          f"{launches['gmm_state_ll'] / blocks[0]:.2f} K1 a block)",
          flush=True)
    for ln in lines:
        print(f"[10]   {ln}", flush=True)
    if not all(lines):
        fail("decode_stream printed no words")
    if min(launches.values()) < 1:
        fail(f"a kernel was not launched by decode_stream: {launches}")
    samples, _ = read_audio(os.path.join(os.path.dirname(
        argv[argv.index("-r") + 1]), "u0.wav"), 16000)
    k2_block, k1_block = _block_kernels(device, task, samples, block)
    # features_range with the fused frontend over a growing buffer, as
    # decode_stream calls it, against the plain frontend's features of
    # the whole utterance
    fused = FeatureGenerator(cfg, fused_mfcc=True, device=device)
    whole = plain_fg.features(samples)
    x = torch.as_tensor(samples, dtype=torch.float32, device=device)
    n_buf = min(8, x.shape[0] // 16000)
    part = torch.cat([fused.features_range(x[:16000 * (k + 1)], 40 * k,
                                           40 * k + 40)
                      for k in range(n_buf)])
    d = float((part - whole[:40 * n_buf]).abs().max())
    print(f"[10] features_range, fused frontend, over growing buffers: "
          f"max|d| {d:.3e} against the plain frontend's whole-utterance "
          f"features (first {40 * n_buf} frames; tolerance 1e-4 x max "
          f"{float(whole.abs().max()):.1f})", flush=True)
    if d > 1e-4 * float(whole.abs().max()):
        fail("features_range with fused_mfcc differs from features")

    # (d) the options at the bench point, on the card
    option_ms = {}
    for name, (fields, extra) in STREAM_OPTIONS.items():
        s2 = _option_search(task, {**BENCH_POINT, **fields}, extra, device)
        sync(device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = s2.decode_batch(obs_opt, n_opt)
        sync(device)
        option_ms[name] = time.perf_counter() - t0
        if s2._la_ctx:
            at_default = _ctx_peak(BeamSearch(
                task.tree, task.fsa, task.model, SearchConfig(
                    lm_scale=30.0, duration_scale=3.0, lm_lookahead=3),
                device=device), 1)
            print(f"[10] {name}: {_ctx_peak(s2, B_opt)}; peak device memory "
                  f"of the decode {_peak_gib(device)}; at the default knobs "
                  f"(W=1024, E=128), B=1, computed: {at_default}", flush=True)
        agree, tot = _planted(res, true_opt, n=B_opt)
        host = DecodeResult(search=s2, **cpu[name].result())
        same = (res[0].words == host.words
                and res[0].final_word == host.final_word
                and np.array_equal(res[0].rec_words, host.rec_words)
                and np.array_equal(res[0].rec_prevs, host.rec_prevs)
                and all(np.allclose(a, b, rtol=1e-5, atol=1e-3) for a, b in (
                    (res[0].log_prob, host.log_prob),
                    (res[0].rec_ams, host.rec_ams),
                    (res[0].rec_lmss, host.rec_lmss))))
        print(f"[10] {name} at the bench point, B={B_opt} T={T_opt}: "
              f"{option_ms[name]:.3f} s ({B_opt * T_opt / 125.0 / option_ms[name]:.1f}x "
              f"real time); planted words {agree}/{tot}; first utterance, "
              f"card against CPU: {'identical' if same else 'DIFFERENT'}",
              flush=True)
        if agree < tot - 1:
            fail(f"{name}: planted words {agree}/{tot} below {tot - 1}/{tot}")
        if not same:
            fail(f"{name}: card and CPU differ on the first utterance")

    # (c) the first WAV on the CPU
    cpu_text, _, cpu_wall = cpu["stream"].result()
    t_cpu_side = time.perf_counter() - t_phase
    pool.shutdown()
    card_w, cpu_w = lines[0].split(), cpu_text.split()
    print(f"[10] decode_stream --device cpu on u0.raw: {cpu_wall:.3f} s; "
          f"words {'identical' if card_w == cpu_w else 'DIFFERENT'} to the "
          f"card's", flush=True)
    if card_w != cpu_w:
        _explain_stream_diff(device, stream_argv, raws[0], cpu_w)
    print(f"[10] phase 10 took {time.perf_counter() - t_phase:.1f} s on "
          f"{card}", flush=True)
    return launches, blocks[0], k2_block, k1_block


def _peak_gib(device) -> str:
    if device.type != "cuda":
        return "not measured (CPU)"
    return f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"


def _ctx_peak(search, B) -> str:
    """The context lookahead's largest intermediate: per backoff level a
    bool mask and a float32 select over [B, tokens, targets, amax], for
    the in-word lanes, the overflow lanes and the re-entry rows (computed
    over whole rows before ``reentry_prewalk`` picks)."""
    cfg = search.config
    amax = search.t["la_pos"].shape[1]
    W = cfg.num_tokens
    A = search._rows_i.slices["arc_tgt"][1]
    Er = min(cfg.reentry_records or cfg.num_records, cfg.num_records)
    pre = "_pre" if search._reentry_pre else ""
    R = search.t["root_tgt" + pre].shape[1]
    groups = {"in-word": W * A, "re-entry": Er * R}
    if cfg.overflow_tokens:
        groups["overflow"] = (min(cfg.overflow_tokens, W)
                              * search.t["over_tgt"].shape[1])
    big = max(groups, key=groups.get)
    return (f"context lookahead amax {amax}, {search._la_levels} levels; "
            f"largest intermediate the {big} lanes' [B={B}, "
            f"{groups[big]}, {amax}] mask + select, "
            f"{5 * B * groups[big] * amax / 2**20:.1f} MiB a level (W*A = "
            f"{groups['in-word']}, Er*R = {groups['re-entry']})")


def _explain_stream_diff(device, stream_argv, raw, cpu_words):
    """The card's and the CPU's decode_stream words differ: run it again
    on the card with the plain scorer (no kernel); if that gives the
    CPU's words, the fused scoring's 3xTF32 sums moved a near tie."""
    from aaltoasr_tpu_torch.cli import decode_stream
    fused_for = decode_stream.scores_full_cov
    decode_stream.scores_full_cov = lambda model: True
    try:
        text, _, _ = _cli(decode_stream.main,
                          stream_argv + ["--device", device.type, raw])
    finally:
        decode_stream.scores_full_cov = fused_for
    same = text.split() == cpu_words
    print(f"[10] decode_stream on the card with the plain scorer: words "
          f"{'identical' if same else 'DIFFERENT'} to the CPU's", flush=True)
    if not same:
        fail("decode_stream on the card and the CPU differ beyond the "
             "fused scoring")


# bench.py's `estep_fps` point: the scoring model, a 256-label chain
# (512 positions, fan 4), B utterances of T frames of N(0, 2) features
ESTEP_POINT = dict(G=10000, S=2500, D=39, K=8, labels=256, B=32, T=1000)


def _estep_inputs(G, S, D, K, labels, B, T):
    """The E-step point's host inputs: (model, table, padded chain graph
    (not shift-compiled), [B, T, D] features), made as bench.py makes
    them."""
    from aaltoasr_tpu_torch.models.hmm import (
        TransitionTable, build_chain, pad_chain)
    from aaltoasr_tpu_torch.synth import random_model
    model = random_model(G=G, S=S, D=D, K=K)
    table = TransitionTable.from_model(model)
    chain = build_chain(model, table,
                        [f"p{i % (S // 2)}" for i in range(labels)])
    P = 512
    while chain.num_positions > P:
        P *= 2
    feats = np.random.default_rng(0).normal(0, 2, (B, T, D)).astype(
        np.float32)
    return model, table, pad_chain(chain, P, fan=4), feats


def _estep_graph(pad, variant):
    from aaltoasr_tpu_torch.train.estep import shift_compile
    return shift_compile(pad) if variant == "shift" else pad


def _train_cpu_job(kind: str, args):
    """Phase [11]'s CPU side, in a worker process of two threads:
    ``"estep"`` runs the E-step point's first utterance (args = the
    point) through both FB forms and returns each form's statistics;
    ``"stats"`` runs `cli.stats` (args = its argv and two output bases)
    as it is, then with the plain FB form (`shift_compile` left out),
    the spread between the two being the CPU's float32 noise floor."""
    torch.set_num_threads(2)
    from aaltoasr_tpu_torch.train import estep
    if kind == "estep":
        from aaltoasr_tpu_torch.ops.gmm import GmmScorer
        from aaltoasr_tpu_torch.train.driver import fetch
        model, table, pad, feats = _estep_inputs(**args)
        scorer = GmmScorer.from_model(model, device="cpu")
        out = {}
        for v in ("plain", "shift"):
            st = estep.chain_stats(
                scorer, torch.as_tensor(feats[:1]),
                estep.stack_graphs([_estep_graph(pad, v)], "cpu"),
                torch.tensor([feats.shape[1]]), table.num_slots)
            out[v] = {k: a[0] for k, a in fetch(st).items()}
        return out
    from aaltoasr_tpu_torch.cli import stats
    argv, shift_out, plain_out = args
    _cli(stats.main, argv + ["-o", shift_out, "--device", "cpu"])
    estep.shift_compile = lambda graph: graph
    _cli(stats.main, argv + ["-o", plain_out, "--device", "cpu"])
    return None


def _profile_call(fn, device, frames: int, cpu: bool = True) -> str:
    """Kernel launches a frame and the device-busy share of one call of
    ``fn`` over ``frames`` frames, from torch.profiler's device events
    (as `_profile_steps`); ``cpu=False`` records the device's activity
    alone (no host op events to build: a call of 10^5 launches)."""
    if device.type != "cuda":
        return "profile not measured (CPU)"
    from torch.profiler import ProfilerActivity, profile
    sync(device)
    with profile(activities=[ProfilerActivity.CUDA]
                 + ([ProfilerActivity.CPU] if cpu else [])) as prof:
        fn()
        sync(device)
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return "device events: not measured (the profiler saw none)"
    copies = sum(e.name.startswith(("Memcpy", "Memset")) for e in dev)
    busy = sum(e.time_range.end - e.time_range.start for e in dev)
    span = (max(e.time_range.end for e in dev)
            - min(e.time_range.start for e in dev))
    return (f"{(len(dev) - copies) / frames:.1f} kernel launches and "
            f"{copies / frames:.2f} copies or fills a frame, device busy "
            f"{100.0 * busy / span:.1f}% of {span / 1e3:.1f} ms "
            f"(profiler, one call)")


def _floor_check(label, got, ref, other, keys, scaled=1e-6):
    """``got`` (the card) against ``ref`` (the CPU, same FB form): each
    key's largest deviation within twice the CPU's own spread between
    its two FB forms (``other`` the second form) plus ``scaled`` of the
    key's scale, and for the feature counts two frames more (a frame
    counts where a posterior passes 1e-32, which float noise moves).
    At T=1,000 and log-likelihoods near 1e5 float32 log posteriors
    carry errors of ~sqrt(T) ulps, so two float32 orders of the same
    sums differ by percents; the floor is measured in the same run.
    Returns the report line; fails beyond the bound."""
    parts = []
    for k in keys:
        a = np.asarray(ref[k], np.float64)
        dev = float(np.abs(np.asarray(got[k], np.float64) - a).max())
        floor = float(np.abs(np.asarray(other[k], np.float64) - a).max())
        scale = max(float(np.abs(a).max()), 1e-30)
        parts.append(f"{k} {dev / scale:.2e} (floor {floor / scale:.2e})")
        if dev > 2 * floor + scaled * scale + 2 * (k == "feacount"):
            fail(f"{label}: {k} deviates {dev:.4g} from the CPU's, beyond "
                 f"twice the CPU's own spread {floor:.4g}")
    return f"{label}: max |card - CPU| / scale: " + ", ".join(parts)


def _same_numbers_check(label, got, ref, keys):
    """The card against the CPU on the same inputs, at the tolerances of
    `tests/test_torch_train.py` (the port against the reference on the
    same inputs): each key's largest deviation within 2e-5 of its scale,
    the moment sums within 1e-4, feature counts identical."""
    parts = []
    for k in keys:
        a = np.asarray(ref[k], np.float64)
        dev = float(np.abs(np.asarray(got[k], np.float64) - a).max())
        scale = max(float(np.abs(a).max()), 1e-30)
        tol = 0 if k == "feacount" else (1e-4 if "acc" in k else 2e-5)
        parts.append(f"{k} {dev / scale:.2e}")
        if dev > tol * scale:
            fail(f"{label}: {k} deviates {dev:.4g} from the CPU's (scale "
                 f"{scale:.4g}, tolerance {tol:g} of it)")
    return f"{label}: max |card - CPU| / scale: " + ", ".join(parts)


def _models_close(ref, ours, rtol=2e-3) -> str:
    """`tests/test_golden_estimate.py:assert_models_close`: means,
    covariances (relative to scale), weights, transitions."""
    worst = {}
    for name in ("means", "covars"):
        a, b = getattr(ref, name), getattr(ours, name)
        worst[name] = float(np.abs(a - b).max()) / max(
            float(np.abs(a).max()), 1e-9)
        if a.shape != b.shape or worst[name] > rtol:
            fail(f"models differ in {name}: {worst[name]:.3g} of scale")
    for s, ((ri, rw), (oi, ow)) in enumerate(zip(ref.mixtures, ours.mixtures)):
        if not (np.array_equal(ri, oi) and np.allclose(rw, ow, rtol=rtol,
                                                       atol=1e-7)):
            fail(f"models differ in mixture {s}")
    for s in ref.transitions:
        rt, ot = sorted(ref.transitions[s]), sorted(ours.transitions[s])
        if ([t for t, _ in rt] != [t for t, _ in ot] or not all(
                abs(rp - op) <= 1e-6 + 1e-4 * abs(op)
                for (_, rp), (_, op) in zip(rt, ot))):
            fail(f"models differ in the transitions of state {s}")
    return ", ".join(f"{k} {v:.2e}" for k, v in worst.items())


class _StageClock(io.StringIO):
    """A stderr that stamps each line it is written with the time since
    it was made: `train`'s progress lines mark its stages' ends."""

    def __init__(self):
        super().__init__()
        self.t0 = time.perf_counter()
        self.stamps = []

    def write(self, text):
        self.stamps.append((time.perf_counter() - self.t0, text.strip()))
        return super().write(text)


def phase_train(device, card="", point=ESTEP_POINT, n_wavs=8,
                seconds=8.0, n_phn=100, clusters=256, reps=3) -> dict:
    """[11] ML training on the card (no kernel of its own, and neither
    K1 nor K2 may launch): (a) the E-step at bench.py's `estep_fps`
    point in both FB forms, timed, profiled, peak memory, the first
    utterance against the CPU; (b) `align`, `stats` and `estimate` on a
    corpus at the bench's width, `stats` against the CPU; (c) `train`,
    2 EM iterations with a split, durations and clusters, its first model
    against (b)'s.  Returns the kernels' launch counts over the phase."""
    import multiprocessing
    import shutil
    from concurrent.futures import ProcessPoolExecutor
    from aaltoasr_tpu_torch.cli import align, estimate, stats, train
    from aaltoasr_tpu_torch.formats import model_io
    from aaltoasr_tpu_torch.formats.feaconf import FeatureConfig
    from aaltoasr_tpu_torch.frontend.audio import read_audio
    from aaltoasr_tpu_torch.frontend.generator import FeatureGenerator
    from aaltoasr_tpu_torch.models.hmm import TransitionTable
    from aaltoasr_tpu_torch.ops.frontend_cuda import mfcc_core
    from aaltoasr_tpu_torch.ops.gmm import GmmScorer
    from aaltoasr_tpu_torch.ops.gmm_cuda import gmm_state_ll
    from aaltoasr_tpu_torch.synth import norm_stats, splice_cfg, write_wav
    from aaltoasr_tpu_torch.train import estep
    from aaltoasr_tpu_torch.train.accumulators import HmmStats, ML_BUF
    from aaltoasr_tpu_torch.train.driver import fetch
    t_phase = time.perf_counter()
    mfcc_core.launches = 0
    gmm_state_ll.launches = 0
    pool = ProcessPoolExecutor(2, mp_context=multiprocessing.get_context(
        "spawn"))
    cpu_estep = pool.submit(_train_cpu_job, "estep", point)

    # (a) the E-step at the bench point, both FB forms
    B, T = point["B"], point["T"]
    model, table, pad, feats = _estep_inputs(**point)
    scorer = GmmScorer.from_model(model, device=device)
    x = torch.as_tensor(feats, device=device)
    n = torch.full((B,), T, dtype=torch.int64, device=device)
    first = {}                  # the card's first utterance, per FB form
    for v in ("plain", "shift"):
        g = estep.stack_graphs([_estep_graph(pad, v)] * B, device)

        def call():
            return estep.chain_stats(scorer, x, g, n, table.num_slots)

        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        out = call()
        sync(device)
        peak = _peak_gib(device)
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = call()
            sync(device)
            walls.append(time.perf_counter() - t0)
        host = fetch(out)
        first[v] = {k: a[0] for k, a in host.items()}
        wall = float(np.median(walls))
        fps = B * T / wall
        lls = host["log_likelihood"]
        if not np.all(np.isfinite(lls)) or np.any(lls <= -1e29):
            fail(f"E-step ({v}): no valid path in the batch")
        # occupancy a frame: 1 in exact arithmetic; float32 log
        # posteriors at these log-likelihoods move it (reported, and held
        # to the CPU's through the gamma key below)
        mass = host["gamma"].sum(1) / T
        print(f"[11] E-step ({v} FB) B={B} T={T} P={pad['pdf'].shape[0]} "
              f"G={point['G']} K={point['K']} D={point['D']}: {fps:.0f} "
              f"frames/s ({fps / 125:.1f}x real time; median of {reps} "
              f"calls, {wall * 1e3:.1f} ms a call: "
              + ", ".join(f"{w * 1e3:.1f}" for w in walls)
              + f"); occupancy a frame {mass.min():.4f}..{mass.max():.4f}"
              f"; peak {peak}; " + _profile_call(call, device, T),
              flush=True)
        del out, host
    cpu = cpu_estep.result()
    keys = ("gamma", "mean_acc", "sec_acc", "mix_gamma", "mix_ll",
            "trans_acc", "feacount")
    for v in ("plain", "shift"):
        other = "shift" if v == "plain" else "plain"
        spread = ", ".join(
            f"{k} {np.abs(cpu[v][k] - cpu[other][k]).max() / max(np.abs(cpu[v][k]).max(), 1e-30):.2e}"
            for k in keys)
        ll_card = float(first[v]["log_likelihood"])
        ll_cpu = float(cpu[v]["log_likelihood"])
        if abs(ll_card - ll_cpu) > 1e-5 * abs(ll_cpu):
            fail(f"E-step ({v}): log-likelihood {ll_card} on the card, "
                 f"{ll_cpu} on the CPU")
        print(f"[11]   utterance 0, log-likelihood {ll_card:.3f} (card) "
              f"{ll_cpu:.3f} (CPU); " + _same_numbers_check(
                  f"E-step ({v} FB)", first[v], cpu[v], keys)
              + f"; the CPU's two FB forms differ by {spread}", flush=True)

    # (b) align, stats, estimate on a corpus at the bench's width
    root = tempfile.mkdtemp(prefix="train", dir=os.environ.get("TMPDIR"))
    p = lambda *names: os.path.join(root, *names)  # noqa: E731
    rng = np.random.default_rng(5)
    wavs = []
    for u in range(n_wavs):
        wavs.append(p(f"u{u}.wav"))
        write_wav(wavs[-1], rng.normal(0, 1000, int(16000 * seconds)))
    # the splice + LDA features, normalized on these WAVs (zero mean,
    # unit variance: the random model's scale, as at the bench point)
    raw = FeatureGenerator(FeatureConfig.parse(splice_cfg()), device=device)
    frames = np.concatenate([raw.features(read_audio(w, 16000)[0]).cpu()
                             .numpy() for w in wavs])
    with open(p("feats.cfg"), "w") as f:
        f.write(splice_cfg(norm=norm_stats(frames)))
    model_io.write_model(p("am"), model)
    lines = []
    for u, wav in enumerate(wavs):
        labels = rng.integers(0, point["S"] // 2, n_phn)
        with open(p(f"u{u}.phn"), "w") as f:
            f.write("".join(f"p{i}\n" for i in labels))
        lines.append(f"audio={wav} transcript={p(f'u{u}.phn')} "
                     f"alignment={p(f'u{u}.ali.phn')}")
    with open(p("recipe"), "w") as f:
        f.write("\n".join(lines) + "\n")
    task = ["-b", p("am"), "-c", p("feats.cfg"), "-r", p("recipe")]
    cpu_stats = pool.submit(_train_cpu_job, "stats",
                            (task, p("cpu_shift"), p("cpu_plain")))
    on = ["--device", device.type]
    walls = {}
    _, _, walls["align"] = _cli(align.main, task + on)
    n_seg = sum(1 for _ in open(p("u0.ali.phn")))
    _, _, walls["stats"] = _cli(stats.main, task + ["-o", p("card")] + on)
    with open(p("stats.lst"), "w") as f:
        f.write(p("card") + "\n")
    _, _, walls["estimate"] = _cli(estimate.main, [
        "-b", p("am"), "-L", p("stats.lst"), "-o", p("est"), "--ml",
        "--minvar", "0.1"])

    # (c) train: 2 EM iterations, a split, durations, clusters (the CPU
    # side of (b) runs meanwhile)
    clock = _StageClock()
    argv = task + ["-w", p("work"), "--id", "m", "--num-iters", "2",
                   "--split-frequency", "2", "--split-stop-iter", "2",
                   "--split-minocc", "1", "--mllt-start-iter", "0",
                   "--durations", "--dur-mincount", "2", "--num-clusters",
                   str(clusters), "-i", "1"] + on
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(clock):
        rc = train.main(argv)
    sync(device)
    t_train = time.perf_counter() - t0
    if rc not in (0, None):
        fail(f"train returned {rc}")

    cpu_stats.result()
    pool.shutdown()
    dumps = {}
    for name in ("card", "cpu_shift", "cpu_plain"):
        dumps[name] = HmmStats.zeros(model, table)
        dumps[name].load(p(name), table)
    flat = {name: dict(
        {k: getattr(d.buffers[ML_BUF], k) for k in keys if k != "trans_acc"},
        trans_acc=d.trans_acc) for name, d in dumps.items()}
    ll = {name: d.num_ll for name, d in dumps.items()}
    if abs(ll["card"] - ll["cpu_shift"]) > 1e-4 * abs(ll["cpu_shift"]):
        fail(f"stats: log-likelihood {ll['card']} on the card, "
             f"{ll['cpu_shift']} on the CPU")
    if dumps["card"].num_frames != dumps["cpu_shift"].num_frames:
        fail("stats: frame counts differ between the card and the CPU")
    print(f"[11] corpus: {n_wavs} WAVs x {seconds:g} s, {n_phn} labels "
          f"each, splice + LDA features (D={point['D']}), the E-step "
          f"point's model; align {walls['align']:.2f} s ({n_seg} segments "
          f"in u0), stats {walls['stats']:.2f} s "
          f"({dumps['card'].num_frames} frames, log-likelihood "
          f"{ll['card']:.1f} card, {ll['cpu_shift']:.1f} CPU), estimate "
          f"{walls['estimate']:.2f} s", flush=True)
    print("[11]   " + _floor_check("stats dumps", flat["card"],
                                   flat["cpu_shift"], flat["cpu_plain"],
                                   keys), flush=True)

    summary = [ln.split() for ln in open(p("work", "m.summary"))]
    lls = [float(f[3]) for f in summary]
    if len(lls) != 2 or not lls[1] > lls[0]:
        fail(f"train: log-likelihood did not rise: {lls}")
    gauss = [int(f[7]) for f in summary]
    for ext in ("dur", "gcl"):
        if not os.path.exists(p("work", f"m_2.{ext}")):
            fail(f"train wrote no m_2.{ext}")
    close = _models_close(model_io.read_model(p("est")),
                          model_io.read_model(p("work", "m_1")))
    marks = [(t, text) for t, text in clock.stamps
             if text.startswith(("Iteration", "Duration"))]
    stages, last = [], 0.0
    for t, text in marks:
        stages.append(f"{text.split(':')[0].split(' written')[0]} "
                      f"{t - last:.2f} s")
        last = t
    stages.append(f"clusters {t_train - last:.2f} s")
    print(f"[11] train, 2 EM iterations: {t_train:.2f} s ("
          + "; ".join(stages) + f"); log-likelihood {lls[0]:.1f} -> "
          f"{lls[1]:.1f}, Gaussians {gauss}; m_1 against estimate's "
          f"model: {close} of scale", flush=True)

    launches = {"mfcc_core": mfcc_core.launches,
                "gmm_state_ll": gmm_state_ll.launches}
    if any(launches.values()):
        fail(f"a TPU kernel launched on the training path: {launches}")
    shutil.rmtree(root)
    print(f"[11] launches over the phase {launches} (neither kernel is on "
          f"this path); phase 11 took {time.perf_counter() - t_phase:.1f} s "
          f"on {card}", flush=True)
    return launches


# discriminative training at phase 11's E-step point: a numerator network
# of one 256-label transcript and a denominator of it and 7 more random
# 256-label transcripts (an 8-path union), B utterances of T frames of
# N(0, 2) features; the segment-mode FB at max_dur, at B=1 only.  The
# profiler records one call over the first T_prof frames; the segment
# mode's CPU check runs paths of seg_labels labels over seg_T frames (at
# the full point one CPU thread takes minutes)
DISCRIM_POINT = dict(G=10000, S=2500, D=39, K=8, labels=256, paths=8,
                     B=32, T=1000, max_dur=64, T_prof=250, seg_labels=24,
                     seg_T=120)
# the E-step passes of the discriminative path, as `chain_stats` and
# `train/mpe.py` run them (phase [12])
DISCRIM_MODES = ("mpv", "mmi", "mpfe-pdf", "seg-mpe")
# statistics keys held card against CPU: the ML-style passes, then the
# MPE numerator and denominator buffers
_CHAIN_KEYS = ("gamma", "mean_acc", "sec_acc", "mix_gamma", "mix_ll",
               "trans_acc", "feacount")
_MPE_KEYS = tuple(f"{b}.{k}" for b in ("num", "den") for k in (
    "gamma", "mean_acc", "sec_acc", "mix_gamma", "feacount"))


def _seg_check_point(point) -> dict:
    return dict(point, labels=point["seg_labels"], T=point["seg_T"], B=1)


def _discrim_inputs(G, S, D, K, labels, paths, B, T, **_):
    """(model, table, numerator FST, denominator FST, [B, T, D] features)
    of the discriminative point, from a seed."""
    from aaltoasr_tpu_torch.models.hmm import TransitionTable
    from aaltoasr_tpu_torch.models.hmmnet import transcript_hmmnet, union_fst
    from aaltoasr_tpu_torch.synth import random_model
    model = random_model(G=G, S=S, D=D, K=K)
    table = TransitionTable.from_model(model)
    rng = np.random.default_rng(12)
    nets = [transcript_hmmnet(model, table, [
        f"p{i}" for i in rng.integers(0, S // 2, labels)])
        for _ in range(paths)]
    den = nets[0]
    for net in nets[1:]:
        den = union_fst(den, net)
    feats = rng.normal(0, 2, (B, T, D)).astype(np.float32)
    return model, table, nets[0], den, feats


class _DiscrimPoint:
    """The discriminative point's passes on ``device``: graphs compiled
    and shift-compiled as `EStepDriver` compiles them, the segment
    table of utterance 0 from its numerator alignment."""

    def __init__(self, point, device, plain_den=False):
        from aaltoasr_tpu_torch.formats.feaconf import FeatureConfig
        from aaltoasr_tpu_torch.synth import splice_cfg
        from aaltoasr_tpu_torch.train import mpe
        from aaltoasr_tpu_torch.train.driver import EStepDriver
        self.point, self.device = point, device
        (self.model, self.table, self.num_fst, self.den_fst,
         self.feats) = _discrim_inputs(**point)
        self.drv = EStepDriver(self.model, FeatureConfig.parse(splice_cfg()),
                               device=device)
        self.num_g = self.drv.graph_from_fst(self.num_fst)
        self.den_g = self.drv.graph_from_fst(self.den_fst)
        if plain_den:               # the plain FB form: no shift tables
            self.den_g = {k: v for k, v in self.den_g.items()
                          if not k.startswith(("sh_", "ir_"))}
        self.membership = torch.as_tensor(mpe.phone_membership(self.model),
                                          device=device)
        self._stacked = {}
        self._seg = {}

    def graphs(self, B):
        if B not in self._stacked:
            from aaltoasr_tpu_torch.train.estep import stack_graphs
            self._stacked = {B: (stack_graphs([self.num_g] * B, self.device),
                                 stack_graphs([self.den_g] * B,
                                              self.device))}
        return self._stacked[B]

    def seg_inputs(self, T):
        """(table [1, T+1, D+1, C], classes [1, P]) of utterance 0's
        first T frames."""
        if T not in self._seg:
            x = torch.as_tensor(self.feats[0, :T], device=self.device)
            acc, cls, _ = self.drv.segment_table(
                x, T, self.num_g, self.num_fst, self.den_g, self.den_fst,
                "mpe", self.point["max_dur"])
            self._seg[T] = (acc, cls)
        return self._seg[T]

    def call(self, mode, B, T=None):
        """A no-argument callable running ``mode`` over the first B
        utterances (and T frames) of the features."""
        from aaltoasr_tpu_torch.train import estep, mpe
        T = T or self.point["T"]
        x = torch.as_tensor(self.feats[:B, :T], device=self.device)
        n = torch.full((B,), T, dtype=torch.int64, device=self.device)
        num, den = self.graphs(B)
        sc, NT = self.drv.scorer, self.table.num_slots
        if mode == "mpv":
            return lambda: estep.chain_stats(sc, x, den, n, NT, mode="mpv")
        if mode == "mmi":
            return lambda: estep.chain_stats(sc, x, den, n, NT,
                                             arc_feacount=True)
        if mode == "mpfe-pdf":
            return lambda: mpe.mpe_stats(sc, x, num, den, n, NT,
                                         mode="mpfe-pdf",
                                         membership=self.membership)
        acc, cls = self.seg_inputs(T)
        return lambda: mpe.mpe_stats_seg(sc, x, None, den, n, NT, acc, cls,
                                         self.point["max_dur"])


def _flat0(out) -> dict:
    """Utterance 0 of a pass's statistics as flat numpy arrays."""
    from aaltoasr_tpu_torch.train.driver import fetch
    if "num" in out:
        flat = {f"{b}.{k}": v[0] for b in ("num", "den")
                for k, v in fetch(out[b]).items()}
        flat.update(log_likelihood=float(out["log_likelihood"][0]),
                    avg_accuracy=float(out["avg_accuracy"][0]))
        return flat
    return {k: v[0] for k, v in fetch(out).items()}


def _discrim_cpu_job(kind: str, args):
    """Phase [12]'s CPU side, in a worker process of one thread:
    ``"point"`` runs utterance 0 of the discriminative point through
    ``args`` = (point, mode) (the segment mode on `_seg_check_point`;
    the MMI pass also in the plain FB form, a second float32 order); a
    CLI module (args = (argv, the directory of the card's features)) runs
    on the card's features (`_card_features`; `make_hmmnets` on the
    card's log-probs, `_card_log_probs`), `cli.stats` with ``-H`` alone
    also in the plain FB form (to an output base + ".plain")."""
    torch.set_num_threads(1)
    if kind == "point":
        point, mode = args
        if mode == "seg-mpe":
            point = _seg_check_point(point)
        out = {"cpu": _flat0(_DiscrimPoint(point, torch.device("cpu"))
                             .call(mode, 1)())}
        if mode == "mmi":
            out["other"] = _flat0(_DiscrimPoint(
                point, torch.device("cpu"), plain_den=True).call(mode, 1)())
        return out
    import importlib
    from aaltoasr_tpu_torch.train import estep
    argv, feature_dir = args
    _card_features(feature_dir)
    if kind.endswith(".make_hmmnets"):
        _card_log_probs(feature_dir)
    main = importlib.import_module(kind).main
    _cli(main, argv + ["--device", "cpu"])
    if kind.endswith(".stats") and argv[argv.index("-o") - 1] == "-H":
        estep.shift_compile = lambda graph: graph
        out = argv.index("-o") + 1
        _cli(main, argv[:out] + [argv[out] + ".plain"] + argv[out + 1:]
             + ["--device", "cpu"])
    return None


def _feature_key(samples) -> str:
    import hashlib
    return hashlib.sha1(np.asarray(samples).tobytes()).hexdigest()


def _card_log_probs(feature_dir):
    """`PhoneProbs.log_probs` returns the card's LNA log-probs of the
    same samples (``lp_<sha1>.npy``, recorded by `_recording_log_probs`):
    the CPU decodes the scores the card decoded (the fused kernels'
    3xTF32 sums and the frontends' float32 noise move a word graph's
    near ties and posterior pruning otherwise)."""
    from aaltoasr_tpu_torch.models.phone_probs import PhoneProbs
    PhoneProbs.log_probs = lambda self, samples: np.load(os.path.join(
        feature_dir, "lp_" + _feature_key(samples) + ".npy"))


@contextlib.contextmanager
def _recording_log_probs(feature_dir):
    """`PhoneProbs.log_probs` as it is, each result also saved for
    `_card_log_probs`."""
    from aaltoasr_tpu_torch.models.phone_probs import PhoneProbs
    log_probs = PhoneProbs.log_probs

    def recording(self, samples):
        out = log_probs(self, samples)
        np.save(os.path.join(feature_dir,
                             "lp_" + _feature_key(samples) + ".npy"), out)
        return out

    PhoneProbs.log_probs = recording
    try:
        yield
    finally:
        PhoneProbs.log_probs = log_probs


@contextlib.contextmanager
def _recording_features(feature_dir):
    """`FeatureGenerator.features` as it is, each result also saved for
    `_card_features` (the last call on the same samples wins: in
    `recognize --adapt`, LNA generation's features, after estimation's)."""
    from aaltoasr_tpu_torch.frontend.generator import FeatureGenerator
    features = FeatureGenerator.features

    def recording(self, samples, num_samples=None):
        out = features(self, samples, num_samples)
        np.save(os.path.join(feature_dir, _feature_key(samples) + ".npy"),
                out.cpu().numpy())
        return out

    FeatureGenerator.features = recording
    try:
        yield
    finally:
        FeatureGenerator.features = features


def _card_features(feature_dir):
    """`FeatureGenerator.features` returns the card's features of the
    same samples (saved by phase [12] (b) as ``<sha1>.npy``): the CPU's
    E-step then sees the card's inputs, as in (a) (the frontends differ
    by float32 noise, which log posteriors at T=1,000 amplify to
    percents: `tools/torch_estep_precision.py`)."""
    from aaltoasr_tpu_torch.frontend.generator import FeatureGenerator

    def features(self, samples, num_samples=None):
        return torch.as_tensor(np.load(os.path.join(
            feature_dir, _feature_key(samples) + ".npy")), device=self.device)

    FeatureGenerator.features = features


def _mpe_unit(ref, k) -> float:
    """gamma_mpe's own tolerance, 2e-4 (`tests/test_torch_discrim.py`),
    carried to MPE-buffer key ``k``: times the buffer's largest moment
    sum over its largest occupancy for the moment sums."""
    buf, name = k.rsplit(".", 1)
    if name not in ("mean_acc", "sec_acc"):
        return 2e-4
    occ = float(np.abs(np.asarray(ref[buf + ".gamma"])).max(initial=0.0))
    return 2e-4 * float(np.abs(np.asarray(ref[k])).max(initial=0.0)) / max(
        occ, 1e-30)


def _discrim_check(label, got, ref, keys, other=None):
    """The card's statistics against the CPU's on the same inputs: each
    key within the larger of `_same_numbers_check`'s tolerances (2e-5
    of its scale, 1e-4 for moment sums) and twice the spread ``other``
    (a second float32 order of the same sums) plus 1e-6 of scale; the
    MPE buffers within the larger of 1e-3 of scale and gamma_mpe's own
    tolerance (`_mpe_unit`): gamma_mpe = gamma x (A + B - average), A
    and B up to the segment or frame count and their difference O(1),
    so float32's 6e-8 on A and B reaches 1e-4 of the buffers' scale and
    more at T=1,000 (2.2e-4 on the segment check's network, 2e-4 in a
    `stats --mpe` run on the card); feature counts identical, but in the
    MPE buffers, which count responsibilities above 1e-10 of that noisy
    gamma_mpe, within 2 (phase 11's rule for a threshold that float
    noise moves) for the Gaussians whose occupancy passes 1e-3 (below
    it gamma_mpe can be noise alone).  Returns the report."""
    parts = []
    for k in keys:
        a = np.asarray(ref[k], np.float64)
        b = np.asarray(got[k], np.float64)
        mpe = k.startswith(("num.", "den.", "mpe_"))
        if k.endswith("feacount"):
            mask = (np.asarray(ref[k.replace("feacount", "gamma")]) > 1e-3
                    if mpe else np.ones(a.shape, bool))
            diff = np.abs(a[mask] - b[mask])
            parts.append(f"{k} {int((diff > 0).sum())} of {int(mask.sum())}"
                         f" differ (max {int(diff.max(initial=0))})")
            if diff.max(initial=0) > (2 if mpe else 0):
                fail(f"{label}: {k} differs from the CPU's by up to "
                     f"{int(diff.max())} in {int((diff > 0).sum())} "
                     "Gaussians")
            continue
        dev = float(np.abs(b - a).max(initial=0.0))
        scale = max(float(np.abs(a).max(initial=0.0)), 1e-30)
        tol = (1e-4 if "acc" in k else 2e-5) * scale
        if mpe:
            tol = max(1e-3 * scale, _mpe_unit(ref, k))
        note = ""
        if other is not None:
            floor = float(np.abs(np.asarray(other[k], np.float64)
                                 - a).max(initial=0.0))
            tol = max(tol, 2 * floor + 1e-6 * scale)
            note = f" (floor {floor / scale:.2e})"
        parts.append(f"{k} {dev / scale:.2e}{note}")
        if not dev <= tol:
            fail(f"{label}: {k} deviates {dev:.4g} from the CPU's (scale "
                 f"{scale:.4g}, tolerance {tol:.4g})")
    return f"{label}: max |card - CPU| / scale: " + ", ".join(parts)


def _net_size(fst, table) -> str:
    from aaltoasr_tpu_torch.models.hmmnet import compile_hmmnet
    g, _ = compile_hmmnet(fst, table)
    return f"P={int(g['num_positions'])} F={g['in_src'].shape[1]}"


def _stats_flat(stats) -> dict:
    """An HmmStats' buffers as flat arrays (``<buffer>.<field>``), its
    transition counts and its three scores."""
    names = {0: "ml", 1: "mmi", 2: "mpe_num", 3: "mpe_den"}
    flat = {"trans_acc": stats.trans_acc, "num_ll": stats.num_ll,
            "den_ll": stats.den_ll, "mpe_score": stats.mpe_score}
    for b, buf in stats.buffers.items():
        for k in ("gamma", "mean_acc", "sec_acc", "mix_gamma", "feacount"):
            flat[f"{names[b]}.{k}"] = getattr(buf, k)
    return flat


def _write_corpus_phn(task, root, n_wavs, n_phn, rng):
    """Random transcripts of the task's phone labels (``n_phn`` each)."""
    labels = [p.label for p in task.model.phones]
    for u in range(n_wavs):
        with open(os.path.join(root, f"u{u}.phn"), "w") as f:
            f.write("".join(f"{labels[i]}\n" for i in
                            rng.integers(0, len(labels), n_phn)))


def phase_discrim(device, card="", point=DISCRIM_POINT, reps=1,
                  n_wavs=4, seconds=8.0, n_phn=60, tokens=64,
                  max_seg_dur=16, n_lna=2, cpu_utts=1,
                  task_args=TASK) -> dict:
    """[12] Discriminative training on hmmnets on the card: (a) the
    mpv FB, the MMI denominator pass, `mpe_stats` (mpfe-pdf) and
    `mpe_stats_seg` (mpe) at the discriminative point, timed at B=1 and
    (but the segment mode) at B, profiled, peak memory, utterance 0
    against the CPU (neither kernel may launch); (b) `make_hmmnets -d`,
    `stats -H` (and -M mpv, --mmi, --mpe in the mpe and mpfe-pdf error
    modes), `train_ebw`, `opt_ebw_d` and `recognize --stateseg` on the
    1,000-word task's WAVs, each against the CPU on the same files (the
    statistics on the first ``cpu_utts`` utterances, `train_ebw` on all
    and, for the comparison, on those; the CPU from the card's features
    and log-probs); K1
    and K2 launch once per utterance each in `make_hmmnets -d` and
    nowhere else.  The task is built with monophones: `wordgraph_hmmnet`
    expands each pronunciation by its phone labels, as the reference's
    does, and a triphone model has no monophone labels.  Returns the
    kernels' launch counts in `make_hmmnets -d`."""
    import multiprocessing
    import shutil
    from concurrent.futures import ProcessPoolExecutor
    from aaltoasr_tpu_torch.cli import (
        estimate, make_hmmnets, opt_ebw_d, recognize, stats, train_ebw)
    from aaltoasr_tpu_torch.formats import model_io
    from aaltoasr_tpu_torch.formats.feaconf import FeatureConfig
    from aaltoasr_tpu_torch.formats.fst import read_fst
    from aaltoasr_tpu_torch.frontend.audio import read_audio
    from aaltoasr_tpu_torch.frontend.generator import FeatureGenerator
    from aaltoasr_tpu_torch.models.hmm import TransitionTable
    from aaltoasr_tpu_torch.ops.frontend_cuda import mfcc_core
    from aaltoasr_tpu_torch.ops.gmm_cuda import gmm_state_ll
    from aaltoasr_tpu_torch.synth import (
        feature_model, synth_task, write_task)
    from aaltoasr_tpu_torch.train import accumulators as acc_mod
    t_phase = time.perf_counter()
    pool = ProcessPoolExecutor(8, mp_context=multiprocessing.get_context(
        "spawn"))
    cpu_point = {m: pool.submit(_discrim_cpu_job, "point", (point, m))
                 for m in DISCRIM_MODES}

    def counts():
        return {"mfcc_core": mfcc_core.launches,
                "gmm_state_ll": gmm_state_ll.launches}

    # (a) the device point
    mfcc_core.launches = 0
    gmm_state_ll.launches = 0
    dp = _DiscrimPoint(point, device)
    B, T = point["B"], point["T"]
    print(f"[12] inputs built at {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    print(f"[12] discriminative point: G={point['G']} K={point['K']} "
          f"D={point['D']}; numerator {point['labels']} labels, P="
          f"{dp.num_g['pdf'].shape[0]} F={dp.num_g['in_src'].shape[1]}; "
          f"denominator {point['paths']} paths, P={dp.den_g['pdf'].shape[0]}"
          f" F={dp.den_g['in_src'].shape[1]} ({len(dp.den_g['ir_src'])} "
          f"irregular edges); T={T}", flush=True)
    card_out = {}
    for mode in DISCRIM_MODES:
        for b in ((1,) if mode == "seg-mpe" else (1, B)):
            call = dp.call(mode, b)
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            out = call()
            sync(device)
            peak = _peak_gib(device)
            if b == 1:
                card_out[mode] = _flat0(out)
            del out
            walls = []
            for _ in range(reps):
                t0 = time.perf_counter()
                call()
                sync(device)
                walls.append(time.perf_counter() - t0)
            wall = float(np.median(walls))
            print(f"[12] {mode} B={b} T={T} (at "
                  f"{time.perf_counter() - t_phase:.1f} s): "
                  f"{b * T / wall:.0f} frames/s "
                  f"({b * T / wall / 125:.1f}x real time; median of {reps} "
                  f"call(s) after a first, ms: "
                  + ", ".join(f"{w * 1e3:.1f}" for w in walls)
                  + f"); peak {peak}; over {point['T_prof']} frames: "
                  + _profile_call(dp.call(mode, b, point["T_prof"]), device,
                                  point["T_prof"], cpu=False), flush=True)
    if any(counts().values()):
        fail(f"a TPU kernel launched at the discriminative point: "
             f"{counts()}")
    for mode in DISCRIM_MODES:
        res = cpu_point[mode].result()
        print(f"[12]   the CPU's {mode} result at "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)
        got = card_out[mode]
        if mode == "seg-mpe":           # the CPU's point, on the card
            got = _flat0(_DiscrimPoint(_seg_check_point(point), device)
                         .call(mode, 1)())
        mpe_mode = "num.gamma" in got
        ll = (got["log_likelihood"], res["cpu"]["log_likelihood"])
        if abs(ll[0] - ll[1]) > 1e-5 * abs(ll[1]):
            fail(f"{mode}: log-likelihood {ll[0]} on the card, {ll[1]} on "
                 "the CPU")
        extra = ""
        if mpe_mode:
            aa = (got["avg_accuracy"], res["cpu"]["avg_accuracy"])
            if abs(aa[0] - aa[1]) > 1e-5 * max(abs(aa[1]), 1.0):
                fail(f"{mode}: average accuracy {aa[0]} on the card, "
                     f"{aa[1]} on the CPU")
            extra = f", average accuracy {aa[0]:.4f} / {aa[1]:.4f}"
        print(f"[12]   {mode} utterance 0"
              + (f" ({point['seg_labels']}-label paths, {point['seg_T']} "
                 "frames)" if mode == "seg-mpe" else "")
              + f": log-likelihood {ll[0]:.3f} (card) {ll[1]:.3f} (CPU)"
              + extra + "; " + _discrim_check(
                  mode, got, res["cpu"],
                  _MPE_KEYS if mpe_mode else _CHAIN_KEYS,
                  other=res.get("other")),
              flush=True)
    del dp, card_out

    # (b) the CLI pipeline on the 1,000-word task's WAVs
    task = synth_task(**dict(task_args, triphone=False))
    root = tempfile.mkdtemp(prefix="discrim", dir=os.environ.get("TMPDIR"))
    p = lambda *names: os.path.join(root, *names)  # noqa: E731
    paths = write_task(task, root, num_wavs=n_wavs, seconds=seconds)
    cfg = FeatureConfig.load(paths["cfg"])
    plain_fg = FeatureGenerator(cfg, device=device)
    # the card's features of each WAV, for the CPU's E-steps
    os.makedirs(p("feats"))
    feats = []
    for u in range(n_wavs):
        samples = read_audio(p(f"u{u}.wav"), 16000)[0]
        feats.append(plain_fg.features(samples).cpu().numpy())
        np.save(p("feats", _feature_key(samples) + ".npy"), feats[-1])
    feats = np.concatenate(feats)
    # the task's model placed on these WAVs' features, no durations
    model = dataclasses.replace(feature_model(task.model, feats, 0.25),
                                durations=None)
    model_io.write_model(p("am"), model)
    rng = np.random.default_rng(7)
    _write_corpus_phn(task, root, n_wavs, n_phn, rng)
    for side, n in (("card", n_wavs), ("cpu", n_wavs),
                    ("check", cpu_utts)):
        net = "cpu" if side == "cpu" else "card"
        with open(p(f"{side}.recipe"), "w") as f:
            f.write("".join(
                f"audio={p(f'u{u}.wav')} transcript={p(f'u{u}.phn')} "
                f"hmmnet={p(f'{net}{u}.num')} "
                f"den-hmmnet={p(f'{net}{u}.den')}\n"
                for u in range(n)))
    base = ["-b", p("am"), "-c", paths["cfg"]]
    mh = ["-d", "--lm", paths["lm"], "--lexicon", paths["lexicon"],
          "--tokens", str(tokens)]
    on = ["--device", device.type]
    walls = {}
    mfcc_core.launches = 0
    gmm_state_ll.launches = 0
    with _recording_log_probs(p("feats")):
        _, _, walls["make_hmmnets -d"] = _cli(
            make_hmmnets.main, base + ["-r", p("card.recipe")] + mh + on)
    mh_launches = counts()
    cpu_mh = [pool.submit(_discrim_cpu_job,
                          "aaltoasr_tpu_torch.cli.make_hmmnets",
                          (base + ["-r", p("cpu.recipe"), "-B", str(n_wavs),
                                   "-I", str(u + 1)] + mh, p("feats")))
              for u in range(n_wavs)]
    if mh_launches != {"mfcc_core": n_wavs, "gmm_state_ll": n_wavs}:
        fail(f"make_hmmnets -d: kernel launches {mh_launches}, not one "
             f"each per utterance ({n_wavs})")
    table = TransitionTable.from_model(model)
    sizes = [_net_size(read_fst(p(f"card{u}.den")), table)
             for u in range(n_wavs)]
    recipe = ["-r", p("card.recipe")]
    check = ["-r", p("check.recipe")]
    stats_runs = {"-H": ["-H"], "-H -M mpv": ["-H", "-M", "mpv"],
                  "-H --mmi": ["-H", "--mmi"],
                  "-H --mpe mpe": ["-H", "--mpe", "--errmode", "mpe",
                                   "--max-seg-dur", str(max_seg_dur)],
                  "-H --mpe mpfe-pdf": ["-H", "--mpe", "--errmode",
                                        "mpfe-pdf"]}
    cpu_stats = {name: pool.submit(
        _discrim_cpu_job, "aaltoasr_tpu_torch.cli.stats",
        (base + check + opts + ["-o", p("cpu_" + name.replace(" ", ""))],
         p("feats"))) for name, opts in stats_runs.items()}
    ebw = ["--criterion", "mmi", "--num-iters", "2"]
    cpu_ebw = pool.submit(_discrim_cpu_job,
                          "aaltoasr_tpu_torch.cli.train_ebw",
                          (base + check + ebw + ["-w", p("ebw_cpu")],
                           p("feats")))
    for name, opts in stats_runs.items():
        _, _, walls[f"stats {name}"] = _cli(
            stats.main, base + check + opts
            + ["-o", p("card_" + name.replace(" ", ""))] + on)
    _, _, walls["train_ebw (2 iterations)"] = _cli(
        train_ebw.main, base + recipe + ebw + ["-w", p("ebw_all")] + on)
    _cli(train_ebw.main, base + check + ebw + ["-w", p("ebw_card")] + on)
    # train_ebw's first iteration against estimate --mmi on `stats
    # --mmi`'s dumps (the same model, networks and card)
    with open(p("mmi.lst"), "w") as f:
        f.write(p("card_-H--mmi") + "\n")
    _cli(estimate.main, ["-b", p("am"), "-L", p("mmi.lst"), "-o",
                         p("est_mmi"), "--mmi", "--C1", "2", "--C2", "2",
                         "--ismooth", "100", "--minvar", "0.1"])
    close_est = _models_close(model_io.read_model(p("est_mmi")),
                              model_io.read_model(p("ebw_card", "ebw_1")))
    # opt_ebw_d on those statistics: D values initialized, one gradient
    # step; the CPU runs it on the same files
    G = model.num_gaussians
    with open(p("gauss.d"), "w") as f:
        f.write("2 0.5 50\n" * G)
    od_argv = ["-b", p("am"), "-L", p("mmi.lst"), "-T", p("mmi.lst"),
               "--control", "mmi", "--train", "mmi", "-D", p("gauss.d")]
    od_outs = {}
    for side in ("card", "cpu"):
        t0 = time.perf_counter()
        runs = [_cli(opt_ebw_d.main, od_argv + [
            "-F", p(f"qp_{side}"), "-o", p(f"d_{side}")] + extra)[0]
            for extra in (["--d-init"], ["--initscale", "0.5"])]
        walls.setdefault("opt_ebw_d", time.perf_counter() - t0)
        od_outs[side] = (runs, open(p(f"d_{side}")).read(),
                         open(p(f"qp_{side}"), "rb").read())
    if od_outs["card"] != od_outs["cpu"]:
        fail("opt_ebw_d: two runs on the same statistics differ")
    # recognize --stateseg on n_lna of the WAVs (LNAs by the plain
    # scorer: no kernel), then the CPU on copies of the same LNAs
    rec_recipe = p("rec.recipe")
    with open(rec_recipe, "w") as f:
        f.write("".join(f"audio={p(f'u{u}.wav')} utterance=u{u}\n"
                        for u in range(n_lna)))
    rec = ["-b", p("am"), "-c", paths["cfg"], "-l", paths["lexicon"], "-n",
           paths["lm"], "-r", rec_recipe, "--stateseg"]
    out_rec, _, walls["recognize --stateseg"] = _cli(
        recognize.main, rec + ["-w", p("rec_card")] + on)
    if counts() != mh_launches:
        fail(f"a TPU kernel launched in phase [12] (b) outside "
             f"make_hmmnets -d: {counts()} after {mh_launches}")
    shutil.copytree(p("rec_card", "lna"), p("rec_cpu", "lna"),
                    ignore=shutil.ignore_patterns("*.stateseg"))
    cpu_rec = pool.submit(_cpu_job, "aaltoasr_tpu_torch.cli.recognize",
                          rec + ["-w", p("rec_cpu"), "--device", "cpu"])

    # the CPU's results
    for u, fut in enumerate(cpu_mh):
        fut.result()
    print(f"[12]   the CPU's networks at {time.perf_counter() - t_phase:.1f}"
          " s", flush=True)
    for u in range(n_wavs):
        for k in ("num", "den"):
            if (open(p(f"card{u}.{k}"), "rb").read()
                    != open(p(f"cpu{u}.{k}"), "rb").read()):
                fail(f"make_hmmnets -d: u{u}'s {k} network differs "
                     "between the card and the CPU")
    print(f"[12] corpus: {n_wavs} WAVs x {seconds:g} s (the CPU's "
          f"statistics on {cpu_utts}), {n_phn}-label "
          f"transcripts, the 1,000-word task's model placed on the "
          f"features; make_hmmnets -d (--tokens {tokens}) "
          f"{walls['make_hmmnets -d']:.2f} s, K1/K2 launches {mh_launches}"
          f"; networks byte-identical on the CPU (decoding the card's "
          f"log-probs); denominators " + "; ".join(str(g) for g in sizes),
          flush=True)
    modes = {name: (acc_mod.PDF_ML_STATS
                    | (acc_mod.PDF_MMI_STATS if "mmi" in name else 0)
                    | ((acc_mod.PDF_MPE_NUM_STATS
                        | acc_mod.PDF_MPE_DEN_STATS) if "mpe" in name else 0))
             for name in stats_runs}
    for name in stats_runs:
        cpu_stats[name].result()
        tag = name.replace(" ", "")
        flat = {}
        for side, dump in (("card", f"card_{tag}"), ("cpu", f"cpu_{tag}"),
                           ("cpu.plain", f"cpu_{tag}.plain")):
            if os.path.exists(p(dump + ".gks")):
                st = acc_mod.HmmStats.zeros(model, table, modes[name])
                st.load(p(dump), table)
                flat[side] = _stats_flat(st)
        for key in ("num_ll", "den_ll", "mpe_score"):
            a, b = flat["card"][key], flat["cpu"][key]
            if abs(a - b) > 1e-5 * abs(b) + 1e-4:
                fail(f"stats {name}: {key} {a} on the card, {b} on the CPU")
        line = _discrim_check(
            f"stats {name}", flat["card"], flat["cpu"],
            [k for k in flat["card"] if "." in k or k == "trans_acc"],
            other=flat.get("cpu.plain"))
        print(f"[12]   stats {name} {walls[f'stats {name}']:.2f} s on "
              f"{cpu_utts} utterance(s): {line}", flush=True)
    cpu_ebw.result()
    summ = [[ln.split() for ln in open(p(d, "ebw.summary"))]
            for d in ("ebw_card", "ebw_cpu", "ebw_all")]
    # iteration 1 scores the same model on the same inputs (rel 1e-4);
    # its models then differ by the statistics' float32 noise, which the
    # EBW update amplifies (num - den + D), so they are held to phase
    # 11's model rule and iteration 2's scores to rel 1e-3
    close_ebw = _models_close(model_io.read_model(p("ebw_cpu", "ebw_1")),
                              model_io.read_model(p("ebw_card", "ebw_1")))
    for it, (r, o) in enumerate(zip(summ[1], summ[0])):
        rel = 1e-4 if it == 0 else 1e-3
        if o[7] != r[7] or any(abs(float(o[i]) - float(r[i]))
                               > rel * abs(float(r[i])) for i in (3, 5)):
            fail(f"train_ebw summary {o} on the card, {r} on the CPU")
    print(f"[12] train_ebw --criterion mmi, 2 iterations: "
          f"{walls['train_ebw (2 iterations)']:.2f} s, criterion "
          + " -> ".join(f[3] for f in summ[2]) + f"; on {cpu_utts} "
          "utterance(s) " + " -> ".join(f[3] for f in summ[0]) + " (card), "
          + " -> ".join(f[3] for f in summ[1]) + " (CPU), num_ll "
          + " -> ".join(f[5] for f in summ[0]) + " / "
          + " -> ".join(f[5] for f in summ[1]) + f", ebw_1 card against "
          f"CPU: {close_ebw} of scale; ebw_1 against "
          f"estimate --mmi on stats --mmi's dumps: {close_est} of scale; "
          f"opt_ebw_d {walls['opt_ebw_d']:.2f} s, the same D file and "
          f"state on a second run", flush=True)
    out_cpu = cpu_rec.result()[0]
    lines = [[ln for ln in o.splitlines() if ln.endswith(")")]
             for o in (out_rec, out_cpu)]
    if lines[0] != lines[1] or len(lines[0]) != n_lna:
        fail(f"recognize --stateseg: lines {lines[0]} on the card, "
             f"{lines[1]} on the CPU")
    segs = []
    for u in range(n_lna):
        a, b = (open(p(d, "lna", f"u{u}.wav.lna.stateseg")).read()
                for d in ("rec_card", "rec_cpu"))
        if a != b:
            fail(f"recognize --stateseg: u{u}'s segments differ between "
                 f"the card and the CPU")
        segs.append(len(a.splitlines()))
    print(f"[12] recognize --stateseg on {n_lna} LNAs: "
          f"{walls['recognize --stateseg']:.2f} s; lines and .stateseg "
          f"files identical on the CPU ({segs} segments); "
          + "; ".join(lines[0]), flush=True)
    pool.shutdown()
    shutil.rmtree(root)
    print(f"[12] stages (s): " + ", ".join(
        f"{k} {v:.2f}" for k, v in walls.items())
        + f"; K1/K2 launches in (b) {counts()} (all in make_hmmnets -d); "
        f"phase 12 took {time.perf_counter() - t_phase:.1f} s on {card}",
        flush=True)
    return mh_launches


# -- [13] speaker adaptation and FST decoding -------------------------------

# phase 11's model width; a 100-label transcript per utterance
ADAPT_POINT = dict(G=10000, S=2500, D=39, K=8, labels=100)
ADAPT_MODES = ("vtln", "mllr", "vtln+mllr", "cmllr")


def _adapt_cpu_job(kind: str, args):
    """Phase [13]'s CPU side, in a worker process of two threads:
    ``"vtln"`` runs `VtlnEstimator` per speaker (args = model base,
    configuration, utterances as (wav, speaker, labels or frame states),
    aligned) and returns {speaker: (warp, curve)}; ``"cmllr"`` runs
    `CmllrEstimator` per speaker and class map (args = model base, the
    card's features as .npy files, labels, speakers, [(C, classes)]) on
    the plain and the shift-compiled forward-backward (the second
    float32 order) and returns {(C, speaker, form): (beta, k, G, W)};
    ``"adapt"`` (args = mode, recognize's argv, a workdir) runs
    `recognize`'s adaptation stage there and, where it estimates MLLR,
    again in ``<workdir>-shift`` with the shift-compiled forward-backward
    (the second float32 order); ``"recognize"`` (args = mode,
    recognize's argv, a workdir holding the card's .spkc, a recipe, the
    card's features) runs `recognize` on the card's features
    (`_card_features`) and returns its lines, wall s and, per WAV, the
    exact LNA codes of the same features (`synth.exact_lna_codes` on the
    speaker's model as the scorer holds it)."""
    torch.set_num_threads(2)
    from aaltoasr_tpu_torch.formats.model_io import read_model
    from aaltoasr_tpu_torch.frontend.audio import read_audio
    from aaltoasr_tpu_torch.frontend.generator import FeatureGenerator
    from aaltoasr_tpu_torch.models.hmm import (
        TransitionTable, build_chain, pad_chain)
    from aaltoasr_tpu_torch.ops.gmm import GmmScorer
    cpu = torch.device("cpu")
    if kind == "adapt":
        import argparse
        from aaltoasr_tpu_torch.cli import mllr, recognize
        from aaltoasr_tpu_torch.train.estep import shift_compile
        mode, argv, own = args
        for work in (own, own + "-shift") if mode != "vtln" else (own,):
            if work != own:
                mllr.pad_chain = lambda chain, n: shift_compile(
                    pad_chain(chain, n))
            os.makedirs(work)
            recognize.adapt(argparse.Namespace(
                am=argv[argv.index("-b") + 1],
                config=argv[argv.index("-c") + 1],
                recipe=argv[argv.index("-r") + 1], workdir=work, info=0,
                device="cpu", adapt=mode))
        return None
    if kind == "recognize":
        from aaltoasr_tpu_torch.cli import recognize
        from aaltoasr_tpu_torch.formats.recipe import Recipe
        from aaltoasr_tpu_torch.models.phone_probs import PhoneProbs
        from aaltoasr_tpu_torch.synth import exact_lna_codes
        mode, argv, same, recipe, feature_dir = args
        _card_features(feature_dir)
        argv = list(argv)
        argv[argv.index("-r") + 1] = recipe
        out, _, wall = _cli(recognize.main, argv + [
            "-w", same, "--adapt", mode, "--device", "cpu"])
        pp = PhoneProbs(argv[argv.index("-b") + 1],
                        argv[argv.index("-c") + 1], device=cpu)
        pp.read_speaker_config(os.path.join(same, f"{mode}.spkc"))
        exact = {}
        for rinfo in Recipe.read(recipe):
            pp.set_speaker(rinfo.speaker_id)
            exact[os.path.basename(rinfo.audio_path)] = exact_lna_codes(
                pp.scored_model,
                pp.fg.features(read_audio(rinfo.audio_path)[0]).numpy())
        return ([ln for ln in out.splitlines() if ln.endswith(")")], wall,
                exact)
    model = read_model(args[0])
    table = TransitionTable.from_model(model)
    scorer = GmmScorer.from_model(model, device=cpu)
    if kind == "vtln":
        from aaltoasr_tpu_torch.train.vtln import VtlnEstimator
        _, cfg, utts, aligned = args
        est = VtlnEstimator(model, table, scorer,
                            FeatureGenerator(cfg, device=cpu), "vtln")
        by_spk = {}
        for wav, spk, lab in utts:
            by_spk.setdefault(spk, []).append(
                (read_audio(wav, 16000)[0], lab))
        return {spk: est.estimate_speaker(u, aligned=aligned)[:2]
                for spk, u in by_spk.items()}
    from aaltoasr_tpu_torch.train.estep import shift_compile
    from aaltoasr_tpu_torch.train.mllr import CmllrEstimator
    _, feat_files, labels, speakers, class_maps = args
    out = {}
    for (C, classes), min_frames in zip(class_maps, (1000.0, 100.0)):
        for spk in sorted(set(speakers)):
            for form in ("plain", "shift"):
                est = CmllrEstimator(scorer, table, classes, C, model.means,
                                     model.covars)
                for u, s in enumerate(speakers):
                    if s != spk:
                        continue
                    chain = build_chain(model, table, labels[u])
                    pad = pad_chain(chain, chain.num_positions)
                    feats = np.load(feat_files[u])
                    est.accumulate(feats, shift_compile(pad) if form ==
                                   "shift" else pad, feats.shape[0])
                acc = est._acc
                out[(C, spk, form)] = (acc["beta"], acc["k"], acc["G"],
                                       est.transforms(min_frames))
    return out


def _codes_check(label, card, cpu, exact) -> str:
    """LNA codes of the card against the CPU's on the same features and
    against the exact (float64, centred-form) codes: within one step and
    >= 99% identical, each."""
    dists = {}
    for name, (x, y) in (("card vs CPU", (card, cpu)),
                         ("card vs exact", (card, exact)),
                         ("CPU vs exact", (cpu, exact))):
        d = np.concatenate([np.abs(a - b).ravel() for a, b in zip(x, y)])
        dists[name] = (float((d == 0).mean()), int(d.max()))
    line = "LNA codes " + ", ".join(
        f"{name} {100 * same:.3f}% identical (largest step {step})"
        for name, (same, step) in dists.items())
    for name in ("card vs CPU", "card vs exact"):
        same, step = dists[name]
        if step > 1 or same < 0.99:
            fail(f"{label}: {line}")
    return line


def _stats_floor_check(label, card, ref, other, keys, scaled=1e-5) -> str:
    """`_floor_check`'s rule on tuples of arrays: each entry within
    twice the CPU's own spread between its two FB forms plus ``scaled``
    of its scale."""
    return _floor_check(label, dict(zip(keys, card)), dict(zip(keys, ref)),
                        dict(zip(keys, other)), keys, scaled)


def _transforms_check(label, card, ref, other) -> float:
    """Per-class transforms of the card within 1e-3 of their scale (the
    largest entry, at least 1) of the CPU's, or within twice the CPU's
    own spread between its two FB forms where that is larger; returns
    the largest deviation over its scale."""
    worst = 0.0
    for c, (a, b, o) in enumerate(zip(card, ref, other)):
        scale = max(1.0, float(np.abs(b).max()))
        dev = float(np.abs(a - b).max())
        floor = float(np.abs(o - b).max())
        worst = max(worst, dev / scale)
        if dev > max(1e-3 * scale, 2 * floor):
            fail(f"{label}: class {c}'s transform deviates {dev:.4g} from "
                 f"the CPU's (scale {scale:.4g}, CPU spread {floor:.4g})")
    return worst


def _mit_phone_loop(model, labels) -> str:
    """A reference-convention search FST (`MitFst`): a loop over the
    phones ``labels``, one node per HMM state (its pdf on the arcs into
    it), the model's transition log-probs as arc weights, each phone's
    last state an end node with arcs into every phone's first state
    (out label: the phone)."""
    first, last, arcs, ends = {}, {}, [], []
    nxt = 1
    for lab in labels:
        states = model.phone(lab).states
        nodes = list(range(nxt, nxt + len(states)))
        nxt += len(states)
        first[lab], last[lab] = (nodes[0], states[0]), nodes[-1]
        ends.append(nodes[-1])
        for i, (node, s) in enumerate(zip(nodes, states)):
            stay, move = (p for _, p in sorted(model.transitions[s]))
            arcs.append(f"T {node} {node} {s} , {np.log(stay):.6f}")
            if i + 1 < len(nodes):
                arcs.append(f"T {node} {nodes[i + 1]} {states[i + 1]} , "
                            f"{np.log(move):.6f}")
    for lab in labels:
        node, s = first[lab]
        arcs.append(f"T 0 {node} {s} {lab} 0.0")
        for src in labels:
            stay, move = (p for _, p in sorted(
                model.transitions[model.phone(src).states[-1]]))
            arcs.append(f"T {last[src]} {node} {s} {lab} "
                        f"{np.log(move):.6f}")
    return "\n".join(["#FSTBasic MaxPlus", "I 0"]
                     + [f"F {n}" for n in ends] + arcs) + "\n"


def _grammar_fst(model, table, rng, paths=8, phones=30):
    """A grammar network in the hmmnet convention, built as `make_hmmnets`
    builds its networks: the union of ``paths`` transcript networks of
    ``phones`` random phones each, every phone's first forward arc
    carrying the phone as its output label."""
    from aaltoasr_tpu_torch.models.hmmnet import transcript_hmmnet, union_fst
    labels = [ph.label for ph in model.phones]
    fst = None
    for _ in range(paths):
        seq = [labels[i] for i in rng.integers(0, len(labels), phones)]
        one = transcript_hmmnet(model, table, seq)
        for arc in one.arcs:
            if arc.source == arc.inst and arc.target != arc.source:
                arc.out_label = arc.label
        fst = one if fst is None else union_fst(fst, one)
    return fst


def phase_adapt_fst(device, task, card="", point=ADAPT_POINT, n_wavs=4,
                    seconds=8.0, workers=6) -> dict:
    """[13] Speaker adaptation and FST decoding on the card, neither K1
    nor K2 launching: (a) VTLN (the 21-point grid, transcript and -O
    modes) and CMLLR (1 class, and 8 regression classes) estimation at
    ``point`` on 4 WAVs of two speakers, timed, profiled, peak memory,
    the card against the CPU on the same inputs; (b) `recognize
    --adapt` in every mode on the 1,000-word task with those WAVs, the
    CPU's own .spkc against the card's and the CPU's recognize on the
    card's .spkc against the card's lines and LNA codes, and those codes
    against the exact (float64) ones; (c) `FstSearch`,
    `FstConfidence` and `MitFstSearch` (gamma durations) on (b)'s LNAs,
    card against CPU.  Returns the kernels' launch counts over the
    phase."""
    import multiprocessing
    import shutil
    from concurrent.futures import ProcessPoolExecutor
    from aaltoasr_tpu_torch.cli import recognize
    from aaltoasr_tpu_torch.decoder.fstsearch import (
        FstConfidence, FstSearch, MitFstSearch)
    from aaltoasr_tpu_torch.formats import model_io
    from aaltoasr_tpu_torch.formats.feaconf import FeatureConfig
    from aaltoasr_tpu_torch.formats.lna import read_lna
    from aaltoasr_tpu_torch.formats.spkc import SpeakerConfig
    from aaltoasr_tpu_torch.frontend.audio import read_audio
    from aaltoasr_tpu_torch.frontend.generator import FeatureGenerator
    from aaltoasr_tpu_torch.models.hmm import (
        TransitionTable, build_chain, pad_chain)
    from aaltoasr_tpu_torch.ops.frontend_cuda import mfcc_core
    from aaltoasr_tpu_torch.ops.gmm import GmmScorer
    from aaltoasr_tpu_torch.ops.gmm_cuda import gmm_state_ll
    from aaltoasr_tpu_torch.synth import (
        adapt_cfg, feature_model, norm_stats, random_model, speaker_wave,
        write_task, write_wav)
    from aaltoasr_tpu_torch.train.mllr import CmllrEstimator
    from aaltoasr_tpu_torch.train.regtree import (
        build_regression_tree, terminal_classes)
    from aaltoasr_tpu_torch.train.vtln import VtlnEstimator, warp_grid
    t_phase = time.perf_counter()
    mfcc_core.launches = 0
    gmm_state_ll.launches = 0
    pool = ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context(
        "spawn"))
    root = tempfile.mkdtemp(prefix="adapt", dir=os.environ.get("TMPDIR"))
    p = lambda *names: os.path.join(root, *names)  # noqa: E731

    # two speakers' WAVs, the second spectrally scaled; the VTLN + MLLR
    # configuration normalized over them at warp 1
    rng = np.random.default_rng(13)
    speakers = [f"s{2 * u // n_wavs}" for u in range(n_wavs)]
    for u, spk in enumerate(speakers):
        write_wav(p(f"u{u}.wav"), speaker_wave(
            rng, 1.0 if spk == "s0" else 1.12, int(16000 * seconds)))
    samples = [read_audio(p(f"u{u}.wav"), 16000)[0] for u in range(n_wavs)]
    plain = FeatureGenerator(FeatureConfig.parse(adapt_cfg(12)), device=device)
    feats = [plain.features(s).cpu().numpy() for s in samples]
    mean, scale = norm_stats(np.concatenate(feats))
    with open(p("adapt.cfg"), "w") as f:
        f.write(adapt_cfg(12, norm=(mean, scale)))
    nfeats = (np.concatenate(feats) - mean) * scale

    # (a) estimation at the point's width
    G, S = point["G"], point["S"]
    model = feature_model(random_model(G=G, S=S, D=point["D"], K=point["K"]),
                          nfeats, 1.0, seed=14)
    model_io.write_model(p("a_am"), model)
    table = TransitionTable.from_model(model)
    labels = [[f"p{i}" for i in rng.integers(0, S // 2, point["labels"])]
              for _ in range(n_wavs)]
    fg = FeatureGenerator(p("adapt.cfg"), device=device)
    T = [fg.num_frames(len(s)) for s in samples]
    chains = [build_chain(model, table, lab) for lab in labels]
    states = [c.pdf[np.arange(t) * c.num_positions // t]
              for c, t in zip(chains, T)]       # an even segmentation
    utts = {False: labels, True: states}
    cpu_vtln = {aligned: pool.submit(_adapt_cpu_job, "vtln", (
        p("a_am"), p("adapt.cfg"),
        [(p(f"u{u}.wav"), speakers[u], utts[aligned][u])
         for u in range(n_wavs)], aligned)) for aligned in (False, True)}
    scorer = GmmScorer.from_model(model, device=device)
    est = VtlnEstimator(model, table, scorer, fg, "vtln")
    warps = warp_grid()
    card_vtln = {}
    for aligned in (False, True):
        mode = "-O" if aligned else "transcript"
        for spk in sorted(set(speakers)):
            us = [u for u in range(n_wavs) if speakers[u] == spk]
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            warp, curve, _ = est.estimate_speaker(
                [(samples[u], utts[aligned][u]) for u in us], aligned=aligned)
            wall = time.perf_counter() - t0
            card_vtln[(aligned, spk)] = (warp, curve)
            frames = sum(T[u] for u in us)
            print(f"[13] (a) VTLN {mode} {spk}: warp {warp:.3f}, "
                  f"{len(warps)} warps x {frames} frames in {wall:.2f} s "
                  f"({frames / wall:.0f} frames/s, {len(warps) * frames / wall:.0f} "
                  f"warp-frames/s); peak {_peak_gib(device)}", flush=True)
        one = ((lambda: est.utterance_lls_aligned(samples[0], states[0], warps))
               if aligned else
               (lambda: est.utterance_lls(samples[0], labels[0], warps)))
        print(f"[13] (a) VTLN {mode}, one utterance of {T[0]} frames at "
              f"{len(warps)} warps: " + _profile_call(one, device, T[0]),
              flush=True)
    if fg._dev_params["vtln"]["warp_matrix"].dim() != 2:
        fail("VTLN estimation left a stacked warp in the generator")
    # CMLLR on the card's features at warp 1 (saved for the CPU)
    cfeats = []
    for u in range(n_wavs):
        cfeats.append(fg.features(samples[u]))
        np.save(p(f"a_feat{u}.npy"), cfeats[-1].cpu().numpy())
    tree = build_regression_tree(model.means, num_terminals=8)
    classes = terminal_classes(tree, G)
    Gp = scorer.score_matrix.shape[1]
    class_maps = []
    for cls in (np.zeros(G, np.int32), classes):
        cp = np.zeros(Gp, np.int32)
        cp[:G] = cls
        class_maps.append((int(cls.max()) + 1, cp))
    cpu_cmllr = pool.submit(_adapt_cpu_job, "cmllr", (
        p("a_am"), [p(f"a_feat{u}.npy") for u in range(n_wavs)], labels,
        speakers, class_maps))
    card_cmllr = {}
    for (C, cp), min_frames in zip(class_maps, (1000.0, 100.0)):
        for spk in sorted(set(speakers)):
            us = [u for u in range(n_wavs) if speakers[u] == spk]
            cest = CmllrEstimator(scorer, table, cp, C, model.means,
                                  model.covars)
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for u in us:
                cest.accumulate(cfeats[u], pad_chain(
                    chains[u], chains[u].num_positions), T[u])
            acc_wall = time.perf_counter() - t0
            Ws = cest.transforms(min_frames)
            wall = time.perf_counter() - t0
            acc = {k: v.copy() for k, v in cest._acc.items()}
            card_cmllr[(C, spk)] = (acc["beta"], acc["k"], acc["G"], Ws)
            frames = sum(T[u] for u in us)
            gate = (np.abs(acc["beta"] - min_frames)
                    / np.maximum(acc["beta"], 1))
            print(f"[13] (a) CMLLR {C} class(es) {spk}: statistics "
                  f"{acc_wall:.2f} s ({frames / acc_wall:.0f} frames/s), "
                  f"solve {wall - acc_wall:.2f} s (host), "
                  f"{int((acc['beta'] >= min_frames).sum())}/{C} classes "
                  f"past the {min_frames:g}-frame gate (closest margin "
                  f"{gate.min():.2e} of beta); peak {_peak_gib(device)}",
                  flush=True)
        print(f"[13] (a) CMLLR {C} class(es), one utterance of {T[0]} "
              f"frames: " + _profile_call(lambda: cest.accumulate(
                  cfeats[0], pad_chain(chains[0], chains[0].num_positions),
                  T[0]), device, T[0]), flush=True)
    est_launches = {"mfcc_core": mfcc_core.launches,
                    "gmm_state_ll": gmm_state_ll.launches}
    if any(est_launches.values()):
        fail(f"a TPU kernel launched in adaptation estimation: "
             f"{est_launches}")

    # (b) recognize --adapt in every mode on the 1,000-word task
    paths = write_task(task, p("task"), num_wavs=0)
    # phase 12's peaked model (as a trained one: words come out); the
    # CPU's recognize reads the card's features (`_card_features`), as
    # phase 12's does: estimated transforms scale the two frontends'
    # float32 differences into LNA steps
    placed = feature_model(task.model, nfeats, 0.25, seed=15)
    model_io.write_model(paths["am"], placed)
    _write_corpus_phn(task, root, n_wavs, 60, rng)
    # the CPU's `recognize` decodes the first utterance of each speaker
    checked = [speakers.index(spk) for spk in sorted(set(speakers))]
    for name, us in (("b", range(n_wavs)), ("b_cpu", checked)):
        with open(p(f"{name}.recipe"), "w") as f:
            f.write("".join(f"audio={p(f'u{u}.wav')} "
                            f"transcript={p(f'u{u}.phn')} "
                            f"speaker={speakers[u]}\n" for u in us))
    argv = ["-b", paths["am"], "-c", p("adapt.cfg"), "-l", paths["lexicon"],
            "-n", paths["lm"], "-r", p("b.recipe"), "--engine", "dense",
            "--decode-batch", str(n_wavs)]
    card_rec, cpu_rec = {}, {}
    cpu_est = {mode: pool.submit(_adapt_cpu_job, "adapt", (
        mode, argv, p(f"cpu_{mode}"))) for mode in ADAPT_MODES}
    for mode in ADAPT_MODES:
        os.makedirs(p(f"feat_{mode}"))
        with _recording_features(p(f"feat_{mode}")):
            out, _, wall = _cli(recognize.main, argv + [
                "-w", p(f"card_{mode}"), "--adapt", mode, "--device",
                device.type])
        card_rec[mode] = ([ln for ln in out.splitlines()
                           if ln.endswith(")")], wall)
        os.makedirs(p(f"same_{mode}"))
        for name in os.listdir(p(f"card_{mode}")):
            if name.endswith(".spkc"):
                shutil.copy(p(f"card_{mode}", name), p(f"same_{mode}"))
        cpu_rec[mode] = pool.submit(_adapt_cpu_job, "recognize", (
            mode, argv, p(f"same_{mode}"), p("b_cpu.recipe"),
            p(f"feat_{mode}")))
        print(f"[13] (b) recognize --adapt {mode} on the card: {wall:.2f} s "
              f"for {n_wavs} x {seconds:g} s (estimation, LNAs, dense "
              f"decode)", flush=True)

    # (c) FST decoding on (b)'s first LNAs, the card against the CPU
    cpu_dev = torch.device("cpu")
    frng = np.random.default_rng(16)
    ptable = TransitionTable.from_model(placed)
    grammar = _grammar_fst(placed, ptable, frng)
    mit_text = _mit_phone_loop(placed, [
        placed.phones[i].label
        for i in frng.choice(len(placed.phones), 30, replace=False)])
    decoders = {
        "FstSearch": lambda d: FstSearch(grammar, placed, ptable, device=d),
        "FstConfidence": lambda d: FstConfidence(grammar, placed, ptable,
                                                 device=d),
        "MitFstSearch": lambda d: MitFstSearch(mit_text, placed,
                                               duration_scale=3.0,
                                               max_dur=32, device=d)}
    for name, make in decoders.items():
        card_dec, cpu_dec = make(device), make(cpu_dev)
        for u in range(2):
            lp = read_lna(p("card_vtln", "lna", f"u{u}.wav.lna"))[0]
            sync(device)
            t0 = time.perf_counter()
            got = (card_dec.run_with_confidence(lp) if name == "FstConfidence"
                   else card_dec.run(lp))
            ms = (time.perf_counter() - t0) * 1e3 / lp.shape[0]
            want = (cpu_dec.run_with_confidence(lp)
                    if name == "FstConfidence" else cpu_dec.run(lp))
            if got[0] != want[0] or abs(got[1] - want[1]) > 1e-5 * abs(want[1]):
                fail(f"{name} u{u}: card {got[:2]}, CPU {want[:2]}")
            if name == "FstConfidence":
                if abs(got[2] - want[2]) > 1e-5 * abs(want[2]) + 1e-6:
                    fail(f"{name} u{u}: confidence {got[2]} on the card, "
                         f"{want[2]} on the CPU")
                extra = f", confidence {got[2]:.6f}"
            else:
                if not np.array_equal(got[2], want[2]):
                    fail(f"{name} u{u}: paths differ between card and CPU")
                extra = ", path identical"
            print(f"[13] (c) {name} u{u}: {len(got[0])} words, score "
                  f"{got[1]:.4f} (CPU {want[1]:.4f}){extra}; {ms:.3f} ms a "
                  f"frame on the card ({lp.shape[0]} frames, P="
                  f"{int(card_dec.graph['in_src'].shape[1])})", flush=True)
        if name == "MitFstSearch":
            got = card_dec.run_with_confidence(lp)
            want = cpu_dec.run_with_confidence(lp)
            if got[0] != want[0] or abs(got[2] - want[2]) > 1e-5 * abs(
                    want[2]) + 1e-6:
                fail(f"MitFstSearch confidence: card {got}, CPU {want}")

    # the CPU sides of (a) and (b)
    keys = ("beta", "k", "G")
    for aligned in (False, True):
        for spk, (warp, curve) in cpu_vtln[aligned].result().items():
            cw, cc = card_vtln[(aligned, spk)]
            rel = float(np.abs(cc - curve).max() / np.abs(curve).max())
            order = np.argsort(-curve)
            gap = curve[order[0]] - curve[order[1]]
            tie = gap <= 1e-5 * abs(curve[order[0]])
            if rel > 1e-5 or (cw != warp and not tie):
                fail(f"VTLN {spk} aligned={aligned}: warp {cw} card, {warp} "
                     f"CPU; curves differ by {rel:.2e} of scale")
            print(f"[13] (a) VTLN {'-O' if aligned else 'transcript'} {spk}: "
                  f"warp {cw:.3f} card, {warp:.3f} CPU; curve max |card - "
                  f"CPU| / scale {rel:.2e}; best two grid points "
                  f"{gap:.4g} apart" + (" (a near tie: either accepted)"
                                        if tie and cw != warp else ""),
                  flush=True)
    cpu = cpu_cmllr.result()
    for C, _ in class_maps:
        for spk in sorted(set(speakers)):
            card_s, ref, other = (card_cmllr[(C, spk)], cpu[(C, spk, "plain")],
                                  cpu[(C, spk, "shift")])
            line = _stats_floor_check(f"CMLLR {C} class(es) {spk}",
                                      card_s[:3], ref[:3], other[:3], keys)
            worst = _transforms_check(f"CMLLR {C} class(es) {spk}",
                                      card_s[3], ref[3], other[3])
            print(f"[13] (a) {line}; transforms {worst:.2e} of scale",
                  flush=True)
    for mode in ADAPT_MODES:
        cpu_est[mode].result()
        lines, wall, exact = cpu_rec[mode].result()
        names = [f"{mode}.spkc"] + (["vtln.spkc"] if mode == "vtln+mllr"
                                    else [])
        worst = 0.0
        for name in names:
            a, b = (SpeakerConfig.load(p(d, name))
                    for d in (f"card_{mode}", f"cpu_{mode}"))
            other = (b if mode == "vtln" else
                     SpeakerConfig.load(p(f"cpu_{mode}-shift", name)))
            for spk, blocks in b.speakers.items():
                for key, cfg in blocks.items():
                    got_cfg = a.speakers[spk][key]
                    for item, _ in cfg.items():
                        x = np.asarray(got_cfg.get_float_vec(item))
                        y = np.asarray(cfg.get_float_vec(item))
                        if item in ("warp_factor", "classes", "gauss_class"):
                            if not np.array_equal(x, y):
                                fail(f"recognize --adapt {mode}: {spk} "
                                     f"{item} {x} card, {y} CPU")
                            continue
                        # (a)'s rule: 1e-3 of scale, or twice the CPU's
                        # own spread between its two FB forms
                        o = np.asarray(other.speakers[spk][key]
                                       .get_float_vec(item))
                        sc = max(1.0, float(np.abs(y).max()))
                        dev = float(np.abs(x - y).max())
                        worst = max(worst, dev / sc)
                        if dev > max(1e-3 * sc,
                                     2 * float(np.abs(o - y).max())):
                            fail(f"recognize --adapt {mode}: {spk} {item} "
                                 f"{dev / sc:.2e} of scale from the CPU's "
                                 f"(its own spread {np.abs(o - y).max() / sc:.2e})")
        if lines != [card_rec[mode][0][u] for u in checked]:
            fail(f"recognize --adapt {mode}: CPU lines {lines}, card "
                 f"{card_rec[mode][0]}")
        codes = _codes_check(
            f"recognize --adapt {mode}",
            *([_read_codes(p(d, "lna", f"u{u}.wav.lna")) for u in checked]
              for d in (f"card_{mode}", f"same_{mode}")),
            [exact[f"u{u}.wav"] for u in checked])
        print(f"[13] (b) recognize --adapt {mode}: .spkc on the CPU within "
              f"{worst:.2e} of scale of the card's (warps equal; the rule "
              f"of (a)); on the "
              f"card's .spkc the CPU's lines of u{checked} identical "
              f"({wall:.1f} s); {codes}; " + "; ".join(lines),
              flush=True)
    pool.shutdown()
    shutil.rmtree(root)
    launches = {"mfcc_core": mfcc_core.launches,
                "gmm_state_ll": gmm_state_ll.launches}
    if any(launches.values()):
        fail(f"a TPU kernel launched in phase [13]: {launches}")
    print(f"[13] K1/K2 launches {launches}; phase 13 took "
          f"{time.perf_counter() - t_phase:.1f} s on {card}", flush=True)
    return launches


# -- [14] decision-tree tying and the host-only training tools ---------------

# the tying corpus: triphones of TIE_CENTERS in the TIE_CONTEXTS, each
# context in one group of TIE_RULES' classes; a state's tone is set by
# (left group, right group, state), so the splits' gains are unambiguous
TIE_CENTERS = ("a", "o")
TIE_CONTEXTS = {"e": 0, "i": 0, "k": 1, "t": 1, "s": 2, "m": 2}
TIE_RULES = ("VOWEL\tcontext\te,i\nSTOP\tcontext\tk,t\n"
             "OTHER\tcontext\ts,m\nE\tcontext\te\nK\tcontext\tk\n")


def _tie_corpus(root, n_wavs, seconds, rng) -> str:
    """``n_wavs`` WAVs of ``seconds`` of tones in noise and their
    state-numbered triphone .phn files (``start end l-c+r.s`` in 16 kHz
    samples, silence ``_.0`` at both ends), 8-14 frames of 128 samples a
    state; returns the recipe's path."""
    from aaltoasr_tpu_torch.synth import write_wav
    ctx = sorted(TIE_CONTEXTS)
    lines = []
    for u in range(n_wavs):
        segs, n_total = [("_", 0, 150.0, 40 * 128)], 80 * 128
        while True:
            c = TIE_CENTERS[rng.integers(len(TIE_CENTERS))]
            l, r = (ctx[i] for i in rng.integers(len(ctx), size=2))
            states = [(f"{l}-{c}+{r}", st,
                       300.0 + 700.0 * TIE_CONTEXTS[l] + 350.0 * st
                       + 160.0 * TIE_CONTEXTS[r]
                       + 2200.0 * TIE_CENTERS.index(c),
                       int(rng.integers(8, 15)) * 128) for st in range(2)]
            n = sum(x[3] for x in states)
            if n_total + n > int(16000 * seconds):
                break
            segs += states
            n_total += n
        segs.append(("_", 0, 150.0, int(16000 * seconds) - n_total + 40 * 128))
        audio, phn, pos = [], [], 0
        for label, st, freq, n in segs:
            t = np.arange(n) / 16000.0
            audio.append(3000 * np.sin(2 * np.pi * freq * t)
                         + 120 * rng.standard_normal(n))
            phn.append(f"{pos} {pos + n} {label}.{st}\n")
            pos += n
        write_wav(os.path.join(root, f"u{u}.wav"),
                  np.concatenate(audio).astype(np.float32))
        with open(os.path.join(root, f"u{u}.phn"), "w") as f:
            f.write("".join(phn))
        lines.append(f"audio={os.path.join(root, f'u{u}.wav')} "
                     f"transcript={os.path.join(root, f'u{u}.phn')}\n")
    with open(os.path.join(root, "tie.recipe"), "w") as f:
        f.write("".join(lines))
    return os.path.join(root, "tie.recipe")


def _tie_cpu_job(argv, feature_dir):
    """Phase [14]'s CPU side, in a worker process of two threads: `tie
    --device cpu` on ``argv``, on the card's features (saved under
    ``feature_dir``) or, with None, on its own frontend's."""
    torch.set_num_threads(2)
    from aaltoasr_tpu_torch.cli import tie
    if feature_dir is not None:
        _card_features(feature_dir)
    return _cli(tie.main, argv + ["--device", "cpu"])[2]


def _basebind_partition(path) -> tuple[int, list]:
    """(number of tied states, per HMM state the set of groups of
    context-phone labels that share a tied state) of a basebind file."""
    binds = {}
    for line in open(path):
        f = line.split()
        if f and f[0] != "_":
            binds[f[0]] = [int(x) for x in f[2:]]
    n = len({i for ids in binds.values() for i in ids})
    parts = []
    for st in range(max(len(ids) for ids in binds.values())):
        groups = {}
        for label, ids in binds.items():
            groups.setdefault(ids[st], set()).add(label)
        parts.append({frozenset(g) for g in groups.values()})
    return n, parts


def _criterion_stats(model, seed):
    """ML (numerator) and MMI (denominator) statistics for ``model``
    made from a seed, with the numerator dominating, so the criterion's
    occupancies are positive."""
    from aaltoasr_tpu_torch.models.hmm import TransitionTable
    from aaltoasr_tpu_torch.train import accumulators as acc
    rng = np.random.default_rng(seed)
    G, D = model.means.shape
    stats = acc.HmmStats.zeros(model, TransitionTable.from_model(model),
                               acc.PDF_ML_STATS | acc.PDF_MMI_STATS)
    for buf_id, scale in ((acc.ML_BUF, 3.0), (acc.MMI_BUF, 1.0)):
        buf = stats.buffers[buf_id]
        gamma = rng.uniform(5, 20, G) * scale
        centers = model.means + rng.normal(0, 0.4, (G, D)) * np.sqrt(
            model.covars)
        buf.gamma[:G] = gamma
        buf.aux_gamma[:G] = gamma
        buf.mean_acc[:G] = centers * gamma[:, None]
        buf.sec_acc[:G] = (model.covars * rng.uniform(0.9, 1.1, (G, D))
                           + centers ** 2) * gamma[:, None]
        for st, (idx, w) in enumerate(model.mixtures):
            buf.mix_gamma[st, :len(idx)] = gamma[idx[0]] * np.asarray(w)
    stats.num_ll, stats.den_ll, stats.num_frames = -100.0, -150.0, 500
    return stats


def phase_tie(device, card="", n_wavs=16, seconds=8.0, count=200) -> dict:
    """[14] Decision-tree tying and the host-only training tools: `tie`
    on ``n_wavs`` synthetic WAVs of ``seconds`` with state-numbered
    triphone .phn files at phase 11's feature width (D=39, `MFCC_CFG`),
    on the card, then `tie --device cpu` in two worker processes: on the
    card's features (basebind and model byte-identical) and on the CPU's
    own frontend (the same tied-state partition); then `optmodel`,
    `clsstep` (both steps) and `clskld` on statistics of the tied model
    on this host.  Neither kernel may launch.  Returns the kernels'
    launch counts over the phase."""
    import multiprocessing
    import shutil
    from concurrent.futures import ProcessPoolExecutor
    from aaltoasr_tpu_torch.cli import clskld, clsstep, optmodel, tie
    from aaltoasr_tpu_torch.formats import model_io
    from aaltoasr_tpu_torch.ops.frontend_cuda import mfcc_core
    from aaltoasr_tpu_torch.ops.gmm_cuda import gmm_state_ll
    from aaltoasr_tpu_torch.synth import MFCC_CFG
    t_phase = time.perf_counter()
    mfcc_core.launches = 0
    gmm_state_ll.launches = 0
    pool = ProcessPoolExecutor(2, mp_context=multiprocessing.get_context(
        "spawn"))
    root = tempfile.mkdtemp(prefix="tie", dir=os.environ.get("TMPDIR"))
    p = lambda *names: os.path.join(root, *names)  # noqa: E731
    recipe = _tie_corpus(root, n_wavs, seconds, np.random.default_rng(14))
    with open(p("feats.cfg"), "w") as f:
        f.write(MFCC_CFG)
    with open(p("rules"), "w") as f:
        f.write(TIE_RULES)
    os.makedirs(p("feats"))

    def argv(side):
        return ["-c", p("feats.cfg"), "-r", recipe, "-u", p("rules"),
                "-b", p(f"{side}.bind"), "-o", p(side), "--count",
                str(count), "--context", "1"]

    own = pool.submit(_tie_cpu_job, argv("own"), None)
    with _recording_features(p("feats")):
        _, _, wall = _cli(tie.main, argv("card") + ["--device", device.type])
    same = pool.submit(_tie_cpu_job, argv("same"), p("feats"))
    frames = sum(np.load(p("feats", name)).shape[0]
                 for name in os.listdir(p("feats")))
    n_card, part_card = _basebind_partition(p("card.bind"))
    if n_card < 4:
        fail(f"tie: only {n_card} tied states")
    same_wall, own_wall = same.result(), own.result()
    if open(p("same.bind"), "rb").read() != open(p("card.bind"), "rb").read():
        fail("tie: the CPU's basebind on the card's features differs")
    for ext in ("ph", "gk", "mc"):
        if (open(p(f"same.{ext}"), "rb").read()
                != open(p(f"card.{ext}"), "rb").read()):
            fail(f"tie: the CPU's .{ext} on the card's features differs")
    n_own, part_own = _basebind_partition(p("own.bind"))
    if (n_own, part_own) != (n_card, part_card):
        fail(f"tie: the CPU's own frontend ties {n_own} states, the card "
             f"{n_card}, or groups them otherwise")
    print(f"[14] tie on {n_wavs} x {seconds:g} s ({frames} frames of "
          f"D=39, {len(TIE_CENTERS)} centers x {len(TIE_CONTEXTS)}^2 "
          f"contexts x 2 states, --count {count}): {wall:.2f} s on the "
          f"card, {n_card} tied states; the CPU on the card's features "
          f"{same_wall:.2f} s (basebind and model byte-identical), on its "
          f"own frontend {own_wall:.2f} s (the same partition)", flush=True)

    # the host-only tools on statistics of the tied model
    model = model_io.read_model(p("card"))
    _criterion_stats(model, 15).dump(p("st"))
    with open(p("st.lst"), "w") as f:
        f.write(p("st") + "\n")
    walls = {}
    # --minvar: the tied model's own variance floor (its tones leave some
    # dimensions near constant)
    minvar = ["--minvar", "0.001"]
    _, _, walls["optmodel"] = _cli(optmodel.main, [
        "-b", p("card"), "-L", p("st.lst"), "-F", p("opt.osf.npz"),
        "-o", p("opt"), "--ml", "1.0", "--mmi", "1.0", "--limit", "0.1"]
        + minvar)
    for out, extra in (("cls", []), ("kldcs", ["--kldcs"])):
        _, _, walls[" ".join(["clsstep"] + extra)] = _cli(clsstep.main, [
            "-b", p("card"), "-L", p("st.lst"), "-o", p(out), "-M", "MMI",
            "--limit", "0.1"] + minvar + extra)
    moved = {}
    for name in ("opt", "cls", "kldcs"):
        m = model_io.read_model(p(name))
        if not (np.isfinite(m.means).all() and np.isfinite(m.covars).all()
                and (m.covars > 0).all()):
            fail(f"{name}: non-finite or non-positive parameters")
        moved[name] = float(np.abs(m.means - model.means).max())
        if moved[name] == 0.0:
            fail(f"{name}: the model did not move")
    if moved["opt"] > 0.1 + 1e-6:
        fail(f"optmodel moved a mean by {moved['opt']}, past --limit 0.1")
    out, _, walls["clskld"] = _cli(clskld.main, [
        "--base1", p("card"), "--base2", p("kldcs"), "-g", "-w"])
    klds = np.array([float(v) for v in out.split()])
    if (len(klds) != model.num_gaussians + len(model.mixtures)
            or not np.isfinite(klds).all() or klds.min() < -1e-9):
        fail(f"clskld: {len(klds)} values, min {klds.min()}")
    print(f"[14] on the tied model ({model.num_gaussians} Gaussians): "
          + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items())
          + f"; largest mean move optmodel {moved['opt']:.4f} (--limit "
          f"0.1), clsstep {moved['cls']:.4f}, --kldcs "
          f"{moved['kldcs']:.4f}; clskld {len(klds)} KLDs, largest "
          f"{klds.max():.4f}", flush=True)
    pool.shutdown()
    shutil.rmtree(root)
    launches = {"mfcc_core": mfcc_core.launches,
                "gmm_state_ll": gmm_state_ll.launches}
    if any(launches.values()):
        fail(f"a TPU kernel launched in phase [14]: {launches}")
    print(f"[14] K1/K2 launches {launches}; phase 14 took "
          f"{time.perf_counter() - t_phase:.1f} s on {card}", flush=True)
    return launches


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs the GPU")
    import aaltoasr_tpu_torch  # noqa: F401  (fails outside the repository)
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)      # name, power limit: as nvidia-smi gives them
    print(f"[1] torch {torch.__version__} CUDA {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}", flush=True)

    phase_build()
    mfcc = phase_mfcc(device)

    from aaltoasr_tpu_torch.synth import synth_task
    t0 = time.perf_counter()
    task = synth_task(**TASK)
    print(f"[5] task built in {time.perf_counter() - t0:.1f} s: "
          f"{task.tree.num_nodes} tree nodes, {task.fsa.num_states} LM "
          f"states, {task.model.num_states} tied states", flush=True)
    gmm = phase_gmm(device, task)
    with tempfile.TemporaryDirectory() as workdir:
        launches, recognize_argv = phase_main_path(device, task, workdir)
        agree, tot = phase_decode(device, task, card=card)
        if agree < tot - 1:
            fail(f"planted-word check {agree}/{tot} below {tot - 1}/{tot}")
        if torch.backends.cuda.matmul.allow_tf32:
            fail("TF32 is on: the full-cov and gated products need IEEE "
                 "float32")
        adapt = phase_adapt(device, task, workdir)
        phase_exact(device, task, recognize_argv, card=card)
        phase_lattice(device, task, recognize_argv, card=card)
        stream = phase_stream(device, task, recognize_argv, card=card)
    phase_adapt_full_width(device)
    train_launches = phase_train(device, card=card)
    discrim_launches = phase_discrim(device, card=card)
    adapt_launches = phase_adapt_fst(device, task, card=card)
    tie_launches = phase_tie(device, card=card)

    kernels = [
        {"name": "mfcc_core", "route": "cuda", "source": MFCC_SOURCE,
         "replaces": MFCC_REPLACES, "launches": launches["mfcc_core"],
         **mfcc},
        {"name": "gmm_state_ll", "route": "cuda", "source": GMM_SOURCE,
         "replaces": GMM_REPLACES, "launches": launches["gmm_state_ll"],
         **gmm},
    ]
    s_launches, s_blocks, k2_block, k1_block = stream
    for k, blk in zip(kernels, (k2_block, k1_block)):
        # the main path's count above; [7]'s per path; [10]'s
        # decode_stream run, its blocks and the kernel at a block's shape
        k["launches_phase7"] = {p: n[k["name"]] for p, n in adapt.items()}
        k["launches_phase10"] = s_launches[k["name"]]
        k["launches_phase11"] = train_launches[k["name"]]
        # [12]: make_hmmnets -d, once per utterance (0 elsewhere)
        k["launches_phase12"] = discrim_launches[k["name"]]
        # [13]: adaptation estimation, recognize --adapt, FST decoding
        k["launches_phase13"] = adapt_launches[k["name"]]
        # [14]: tie and the host-only training tools
        k["launches_phase14"] = tie_launches[k["name"]]
        k["phase10_blocks"] = s_blocks
        k["block_shape"] = blk
    print(f"[15] the whole script took {time.perf_counter() - t_start:.1f} "
          f"s on {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
