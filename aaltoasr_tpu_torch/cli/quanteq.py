"""quanteq: per-utterance quantile-equalization parameter estimation
-> .spkc (`aku/quanteq.cc:37-210`).

Computes per-channel feature quantiles over the recipe audio and grid
searches (alpha, gamma) per channel so the warped quantiles match the
training quantiles stored in the quanteq module's config
(``quant_train``).  Reference quirks preserved: the feature matrix
accumulates ACROSS utterances (quanteq.cc never clears ``fea_mat``
inside the recipe loop), quantiles are clamped from below by the
training quantiles, the grid objective uses the convex-combination
warp ``a*r^g + (1-a)*r`` while the module applies the exponent form
``a*r^(g+(1-a)*r)`` (quanteq.cc:87 vs FeatureModules.cc:2133), and the
last quantile is excluded from the objective.

The grid search itself is one vectorized [C, A, G, Q] numpy reduction
instead of the reference's four nested loops.

Counterpart of `aaltoasr_tpu/cli/quanteq.py`, with the same flags plus
``--device`` for the frontend (default ``cuda``; with no GPU it raises
unless ``--device cpu`` is given).
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np

from aaltoasr_tpu_torch.device import resolve_device
from aaltoasr_tpu_torch.formats.feaconf import ModuleConfig
from aaltoasr_tpu_torch.formats.recipe import Recipe
from aaltoasr_tpu_torch.formats.spkc import SpeakerConfig
from aaltoasr_tpu_torch.frontend.audio import read_audio
from aaltoasr_tpu_torch.frontend.generator import FeatureGenerator


def compute_quantiles(fea_mat: list, quant_train: np.ndarray,
                      num_quant: int) -> np.ndarray:
    """Per-channel quantiles with the reference's index convention
    (quanteq.cc:37-61): q[c][j] = sorted(x_c)[ceil(n*(j+1)/Q)-1],
    clamped from below by the training quantiles."""
    C = len(fea_mat)
    quant = np.empty((C, num_quant))
    for c in range(C):
        x = np.sort(np.asarray(fea_mat[c]))
        n = len(x)
        idx = [int(math.ceil(n * (j + 1) / num_quant)) - 1
               for j in range(num_quant)]
        quant[c] = np.maximum(x[idx], quant_train)
    return quant


def grid_search(quant: np.ndarray, quant_train: np.ndarray,
                alpha_step: float, gamma_step: float,
                gamma_end: float):
    """Vectorized per-channel (alpha, gamma) grid search
    (quanteq.cc:64-102).  Returns (alpha[C], gamma[C], quant_max[C])."""
    alphas = np.arange(0.0, 1.0 + alpha_step / 2, alpha_step)
    gammas = np.arange(0.0, gamma_end + gamma_step / 2, gamma_step)
    qmax = quant[:, -1]                                  # [C]
    r = quant[:, :-1] / qmax[:, None]                    # [C, Q-1]
    # warped[c, a, g, q] = qmax_c * (a * r^g + (1-a) * r)
    rg = r[:, None, None, :] ** gammas[None, None, :, None]
    a = alphas[None, :, None, None]
    warped = qmax[:, None, None, None] * (
        a * rg + (1.0 - a) * r[:, None, None, :])
    score = ((warped - quant_train[None, None, None, :-1]) ** 2
             ).sum(axis=-1)                              # [C, A, G]
    flat = score.reshape(score.shape[0], -1)
    best = flat.argmin(axis=1)        # first minimum = reference order
    ai, gi = np.unravel_index(best, score.shape[1:])
    return alphas[ai], gammas[gi], qmax


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="quanteq")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-r", "--recipe", required=True)
    p.add_argument("-q", "--quanteq", required=True,
                   help="QuantEq module name")
    p.add_argument("-S", "--utterances",
                   help="utterance configuration input file")
    p.add_argument("-o", "--out",
                   help="output utterance configuration file")
    p.add_argument("--num-quant", type=int, default=4)
    p.add_argument("--grid-alpha-step", type=float, default=0.01)
    p.add_argument("--grid-gamma-step", type=float, default=0.01)
    p.add_argument("--grid-gamma-end", type=float, default=3.0)
    p.add_argument("-B", "--batch", type=int, default=0)
    p.add_argument("-I", "--bindex", type=int, default=0)
    p.add_argument("-i", "--info", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a GPU "
                        "unless cpu is given)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)

    fg = FeatureGenerator(args.config, device=device)
    spec = next((m for m in fg.config.modules
                 if m.name == args.quanteq), None)
    if spec is None or spec.type != "quanteq":
        print(f"Module {args.quanteq} is not a QUANTEQ module",
              file=sys.stderr)
        return 1
    quant_train = np.asarray(
        spec.config.get_float_vec("quant_train", []), dtype=np.float64)
    if len(quant_train) != args.num_quant:
        print(f"quant_train has {len(quant_train)} values, expected "
              f"{args.num_quant}", file=sys.stderr)
        return 1

    spkc = (SpeakerConfig.load(args.utterances) if args.utterances
            else SpeakerConfig())
    recipe = Recipe.read(args.recipe, args.batch, args.bindex)

    fea_mat: list = [[] for _ in range(fg.dim)]
    for f, rinfo in enumerate(recipe):
        if args.info > 0:
            print(f"Processing file: {rinfo.audio_path} "
                  f"({f + 1}/{len(recipe.infos)})", file=sys.stderr)
        samples, _ = read_audio(rinfo.audio_path, fg.sample_rate)
        feats = fg.features(samples).cpu().numpy()
        for c in range(fg.dim):
            fea_mat[c].extend(feats[:, c].tolist())
        quant = compute_quantiles(fea_mat, quant_train, args.num_quant)
        alpha, gamma, qmax = grid_search(
            quant, quant_train, args.grid_alpha_step,
            args.grid_gamma_step, args.grid_gamma_end)
        cfg = ModuleConfig()
        cfg.set("alpha", [float(v) for v in alpha])
        cfg.set("gamma", [float(v) for v in gamma])
        cfg.set("quant_max", [float(v) for v in qmax])
        spkc.utterances.setdefault(rinfo.utterance_id or "default", {})[
            ("feature", args.quanteq)] = cfg

    if args.out:
        spkc.save(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
