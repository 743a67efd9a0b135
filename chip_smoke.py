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
   spawned worker processes beside the card's runs.

It then prints one JSON line of per-kernel results (each kernel's time
beside its bound: the larger of its bytes over 3.35 TB/s and its
products as 3xTF32 work over 495 TFLOP/s, the H100 SXM's published
rates) and, last, the device line.  It exits non-zero, before printing
any result, when no CUDA device is present or any check fails.  It
never imports jax.
"""

from __future__ import annotations

import contextlib
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
    flops = {"full-cov": 2.0 * T * (D * D + D) * Gp,
             "gated": 2.0 * T * 2 * D * (Gp + clusters),
             "diagonal": 2.0 * T * 2 * D * Gp}
    for name, sc in (("full-cov", full), ("gated", gated),
                     ("diagonal", dense)):
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
              f"IEEE float32){agree}", flush=True)
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


def main() -> int:
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
        k["phase10_blocks"] = s_blocks
        k["block_shape"] = blk
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
