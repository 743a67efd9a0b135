"""A/B timing of the GMM state-likelihood kernel (K1) on one CUDA GPU.

    python3 tools/torch_gmm_kernel_ab.py [--old OLD.cu] [--alt NAME=SRC.cu]...
        [--ablate NAME]... [--rounds 6] [--out build/gmm_ab.json]

Builds `aaltoasr_tpu_torch/csrc/gmm_state_ll.cu` as the wrapper does,
each ``--ablate`` (the source with a part of the work taken out,
`ABLATIONS`: a timing probe, its results are wrong), each ``--alt``
(another source with the current launcher, e.g. a copy with other
`Tile<...>` arguments) and, with ``--old``, an earlier kernel with the
launcher ``gmm_state_ll_launch(x, we, out, T, D, K, Dq, Spp, stream)``,
all with nvcc for sm_90a under ``build/kernels/ab/``.  Builds with the
current launcher run through the wrapper `gmm_cuda.gmm_state_ll`, its
library swapped for theirs.  Then, in one process:

* each kernel against the plain version (max |d| on the real states);
* device time per call (CUDA-graph replay between CUDA events) at the
  scoring shape (32 x 10 s of noise audio's MFCCs, T=39,936, against the
  bench scoring model G=10,000, S=2,500, K=8) and at one 8 s utterance
  against the main path's 2,704-state model (K=1), in `--rounds` rounds
  whose order alternates (a, b, ..., then ..., b, a); medians;
* both tiles of the wrapper over T at both models (the crossover);
* the fused scoring batch of `scoring_fps` (32 x 10 s of audio on the
  GPU -> fused MFCC -> K1 -> LNA log-probs, host clock to a
  synchronize), with the current and the old K1, alternated.

It prints one line per measurement and writes all of them as JSON.
It needs a GPU and nvcc; it never imports jax.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from aaltoasr_tpu_torch.formats.feaconf import FeatureConfig  # noqa: E402
from aaltoasr_tpu_torch.frontend.generator import (  # noqa: E402
    FeatureGenerator)
from aaltoasr_tpu_torch.ops import cuda_build  # noqa: E402
from aaltoasr_tpu_torch.ops import gmm_cuda as GC  # noqa: E402
from aaltoasr_tpu_torch.ops.gmm import GmmScorer, lna_normalize  # noqa: E402
from aaltoasr_tpu_torch.synth import (  # noqa: E402
    MFCC_CFG, random_model, synth_task)
from chip_smoke import card_line, graph_ms  # noqa: E402

AB_DIR = cuda_build.BUILD_DIR / "ab"
VP, I = ctypes.c_void_p, ctypes.c_int
# timing probes: (text of the source, what replaces it)
ABLATIONS = {
    # the fold without its exponential
    "noexp": [("const float u = __expf(-fabsf(d));", "const float u = 0.f;")],
    # no products at all: the loads, barriers, splits and folds alone
    "no_products": [
        ("      wgmma_tf32(acc, al[j], b_desc(bh + j * 256), q > 0 || j > 0);\n"
         "      wgmma_tf32(acc, ah[j], b_desc(bl + j * 256), 1);\n"
         "      wgmma_tf32(acc, ah[j], b_desc(bh + j * 256), 1);\n", "")],
    # no slab copies (the products read whatever the ring holds): the
    # stage's barrier is arrived on without bytes to wait for
    "no_loads": [
        ('"mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\\n" ::"r"(bar),\n'
         '      "r"(bytes)',
         '"mbarrier.arrive.shared::cta.b64 _, [%0];\\n" ::"r"(bar)'),
        ('  asm volatile(\n'
         '      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "\n'
         '      "[%0], [%1], %2, [%3];\\n" ::"r"(dst),\n'
         '      "l"(src), "r"(bytes), "r"(bar)\n'
         '      : "memory");\n', "")],
    # no fold: the last slot's products are the result
    "no_fold": [("      if (k == 0) {\n        m[i] = ek;",
                 "      if (true) {\n        m[i] = ek;")],
}


def nvcc(src: Path, name: str, edits=()) -> tuple[ctypes.CDLL, str]:
    """Build `src` (with `edits` applied) into build/kernels/ab/<name>.so
    -> (library, ptxas register lines)."""
    AB_DIR.mkdir(parents=True, exist_ok=True)
    out = AB_DIR / f"{name}.so"
    if edits:
        text = src.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"ablation {name}: {old!r} not found once")
            text = text.replace(old, new)
        src = AB_DIR / f"{name}_src.cu"
        src.write_text(text)
    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out),
           str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc {name}: {proc.stderr}")
    log = " | ".join(ln.strip() for ln in (proc.stdout + proc.stderr)
                     .splitlines() if "registers" in ln or "spill" in ln)
    return ctypes.CDLL(str(out)), log


class NewKernel:
    """A build with the current launcher, called through the wrapper with
    its library swapped for this one (and its tile fixed, if given)."""

    def __init__(self, lib):
        self.lib = GC.bind(lib)

    def __call__(self, x, we, dim, tile=None):
        saved = GC._lib, GC.pick_tile
        GC._lib = lambda: self.lib
        if tile is not None:
            GC.pick_tile = lambda *a: tile
        try:
            return GC.gmm_state_ll(x, we, dim)
        finally:
            GC._lib, GC.pick_tile = saved


class OldKernel:
    """An earlier kernel's launcher: the float32 slabs as they are."""

    def __init__(self, lib):
        lib.gmm_state_ll_launch.argtypes = [VP] * 3 + [I] * 5 + [VP]
        lib.gmm_state_ll_launch.restype = I
        self.lib = lib

    def __call__(self, x, we, dim):
        T, (K, Dq, Spp) = x.shape[0], we.shape
        out = torch.empty((T, Spp), device=x.device)
        err = self.lib.gmm_state_ll_launch(
            x.data_ptr(), we.data_ptr(), out.data_ptr(), T, dim, K, Dq, Spp,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", help="an earlier gmm_state_ll.cu to compare")
    ap.add_argument("--alt", action="append", default=[],
                    help="NAME=SRC.cu, a source with the current launcher")
    ap.add_argument("--ablate", action="append", default=[],
                    help=f"NAME[+NAME], of {sorted(ABLATIONS)}")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--out", default=str(ROOT / "build/gmm_ab.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    res = {"card": card_line(), "torch": torch.__version__,
           "cuda": torch.version.cuda}
    print(res["card"], flush=True)

    src = cuda_build.CSRC / GC.SOURCE
    jobs = [("new", src, ())]
    for name in args.ablate:      # "a+b": both probes at once
        edits = [e for part in name.split("+") for e in ABLATIONS[part]]
        jobs.append((name, src, tuple(edits)))
    for a in args.alt:
        name, path = a.split("=")
        jobs.append((name, Path(path), ()))
    if args.old:
        jobs.append(("old", Path(args.old), ()))
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(
            lambda j: nvcc(j[1], f"gmm_ab_{j[0]}", j[2]), jobs))
    kernels = {}
    for (name, _, _e), (lib, log) in zip(jobs, built):
        kernels[name] = OldKernel(lib) if name == "old" else NewKernel(lib)
        print(f"build {name}: {log}", flush=True)
        res.setdefault("builds", {})[name] = {"ptxas": log}

    # the two shapes
    fg = FeatureGenerator(FeatureConfig.parse(MFCC_CFG), fused_mfcc=True,
                          device=dev)
    n = 160000
    g = torch.Generator(device=dev).manual_seed(0)
    samples = torch.randn(32, n, generator=g, device=dev) * 1000.0
    lens = np.full(32, n)
    x_batch = fg.features_batch(samples, lens).reshape(-1, 39).contiguous()
    x_utt = fg.features(samples[0, :128000]).contiguous()
    task = synth_task(num_words=1000, order=3, triphone=True, durations=True)
    scorers = {
        "scoring": GC.FusedGmmScorer.from_scorer(GmmScorer.from_model(
            random_model(G=10000, S=2500, D=39, K=8), device=dev)),
        "utt": GC.FusedGmmScorer.from_scorer(GmmScorer.from_model(
            task.model, device=dev))}
    shapes = {"scoring": (x_batch, scorers["scoring"]),
              "utt": (x_utt, scorers["utt"])}

    for shape, (x, f) in shapes.items():
        S, (K, Dq, Spp) = f.num_states, f.we.shape
        ref = GC.reference_state_ll(x, f.we, 39)
        flops = 2.0 * 79 * K * x.shape[0] * Spp
        entry = {"T": x.shape[0], "S": S, "Spp": Spp, "K": K,
                 "gflop": flops * 1e-9, "max_abs_err": {}, "ms": {}}
        for name, kern in kernels.items():
            out = kern(x, f.we, 39)
            torch.cuda.synchronize()
            entry["max_abs_err"][name] = float(
                (out[:, :S] - ref[:, :S]).abs().max())
        del ref, out
        xq = torch.cat([x * x, x, torch.ones_like(x[:, :1])], dim=1)
        w = f.we[:, :79].permute(1, 0, 2).reshape(79, K * Spp).contiguous()
        fns = {name: (lambda k=kern: k(x, f.we, 39))
               for name, kern in kernels.items()}
        fns["plain"] = lambda: GC.reference_state_ll(x, f.we, 39)
        fns["cublas_product"] = lambda: xq @ w
        iters = 5 if shape == "scoring" else 50
        times = {name: [] for name in fns}
        order = list(fns)
        for r in range(args.rounds):
            for name in (order if r % 2 == 0 else order[::-1]):
                # relaxed: the earlier float32 kernel's launcher sets a
                # function attribute on every call, which a capture in
                # the global mode refuses
                times[name].append(graph_ms(fns[name], dev, iters, reps=3,
                                            capture_error_mode="relaxed"))
        for name, ts in times.items():
            entry["ms"][name] = {"median": statistics.median(ts), "all": ts}
            med = statistics.median(ts)
            print(f"{shape} T={x.shape[0]} Spp={Spp} K={K} {name}: median "
                  f"{med:.4f} ms [{min(ts):.4f}, {max(ts):.4f}], "
                  f"{flops / med * 1e-9:.1f} TFLOP/s, max|d| "
                  f"{entry['max_abs_err'].get(name, 0.0):.3e}", flush=True)
        res[shape] = entry
        del xq, w

    # tile crossover of the current build
    sweep = []
    new = kernels["new"]
    for shape in ("utt", "scoring"):
        f = scorers[shape]
        Spp = f.we.shape[2]
        for T in (256, 512, 1006, 2048, 4096, 8192, 16384, 39936):
            x = x_batch[:T].contiguous()
            row = {"model": shape, "T": T, "Spp": Spp,
                   "picked": GC.pick_tile(T, Spp, 39, torch.cuda
                                          .get_device_properties(dev)
                                          .multi_processor_count)}
            for tile in (0, 1):
                row[f"tile{tile}_ms"] = graph_ms(
                    lambda: new(x, f.we, 39, tile=tile), dev,
                    50 if T < 10000 else 5, reps=3)
            sweep.append(row)
            print(f"tiles {shape} T={T} Spp={Spp}: batch "
                  f"{row['tile0_ms']:.4f} ms, utt {row['tile1_ms']:.4f} ms, "
                  f"picked {row['picked']}", flush=True)
    res["tile_sweep"] = sweep

    # the fused scoring batch of scoring_fps, with the new and the old K1
    f = scorers["scoring"]
    batch = {}
    names = ["new"] + (["old"] if "old" in kernels else [])
    for name in names:
        batch[name] = []
    for r in range(2 * args.rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            kern = kernels[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            feats = fg.features_batch(samples, lens).reshape(-1, 39)
            lp = lna_normalize(kern(feats.contiguous(), f.we, 39)
                               [:, :f.num_states])
            torch.cuda.synchronize()
            batch[name].append((time.perf_counter() - t0) * 1e3)
            del lp
    res["scoring_batch_ms"] = {}
    for name, ts in batch.items():
        med = statistics.median(ts[2:])      # the first rounds warm up
        res["scoring_batch_ms"][name] = {"median": med, "all": ts}
        print(f"scoring batch (32 x 10 s, fused MFCC + K1 {name} + LNA "
              f"normalization, host clock): median {med:.3f} ms, "
              f"{x_batch.shape[0] / med:.0f}k frames/s", flush=True)

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
