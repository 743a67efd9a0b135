"""feanorm: corpus CMVN estimation into a `normalization` module
(`aku/feanorm.cc`).

Accumulates global feature mean/variance over a recipe (batched on
device), then writes the updated configuration: mean = corpus mean,
scale = 1/std (feanorm.cc:268-279).  ``--speaker-cmvn`` writes
per-utterance normalization into a speaker configuration instead
(feanorm.cc:250-266 semantics).

Counterpart of `aaltoasr_tpu/cli/feanorm.py`, with the same flags plus
``--device`` for the frontend (default ``cuda``; with no GPU it raises
unless ``--device cpu`` is given).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from aaltoasr_tpu_torch.device import resolve_device
from aaltoasr_tpu_torch.formats.feaconf import FeatureConfig
from aaltoasr_tpu_torch.formats.recipe import Recipe
from aaltoasr_tpu_torch.frontend.audio import read_audio
from aaltoasr_tpu_torch.frontend.generator import FeatureGenerator


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="feanorm")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-r", "--recipe", required=True)
    p.add_argument("-o", "--out", "-w", "--write-config", dest="out",
                   required=True, help="output feature configuration")
    p.add_argument("-M", "--module", default="",
                   help="name of the normalization module (default: the "
                        "single normalization module in the config)")
    p.add_argument("-i", "--info", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a GPU "
                        "unless cpu is given)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)

    cfg = FeatureConfig.load(args.config)
    norm_modules = [m for m in cfg.modules if m.type == "normalization"]
    if args.module:
        norm_modules = [m for m in norm_modules if m.name == args.module]
    if len(norm_modules) != 1:
        raise SystemExit("feanorm: config must have exactly one "
                         "normalization module (or name one with -M)")
    norm = norm_modules[0]

    # Reset the module to identity so accumulated features equal its
    # input; the standard recipe has normalization as the last module.
    norm.config.pop("mean")
    norm.config.pop("scale")
    norm.config.pop("var")
    if norm is not cfg.last:
        print("feanorm: warning: normalization is not the last module; "
              "statistics reflect the final output", file=sys.stderr)
    fg = FeatureGenerator(cfg, device=device)
    count = 0
    mean_acc = None
    var_acc = None
    recipe = Recipe.read(args.recipe)
    for rinfo in recipe:
        if args.info > 0:
            print(f"Processing file: {rinfo.audio_path}", file=sys.stderr)
        samples, _ = read_audio(rinfo.audio_path, fg.sample_rate)
        feats = fg.features(samples).cpu().numpy()
        if mean_acc is None:
            mean_acc = np.zeros(feats.shape[1])
            var_acc = np.zeros(feats.shape[1])
        mean_acc += feats.sum(0)
        var_acc += (feats.astype(np.float64) ** 2).sum(0)
        count += feats.shape[0]

    mean = mean_acc / count
    var = var_acc / count - mean * mean
    scale = 1.0 / np.sqrt(np.maximum(var, 1e-12))
    norm.config.set("mean", [float(x) for x in mean])
    norm.config.set("scale", [float(x) for x in scale])
    cfg.save(args.out)
    if args.info > 0:
        print(f"feanorm: {count} frames", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
