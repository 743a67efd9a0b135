"""stats: the E-step worker — recipe shard -> statistics dumps.

Counterpart of `aaltoasr_tpu/cli/stats.py` (`aku/stats.cc:309-470`):
``-b/-g/-m/-p`` model, ``-c`` config, ``-r`` recipe, ``-o`` output base,
``-M bw|vit``, ``-O`` (fixed alignments), ``--fullstats``,
``--device-batch``, ``-B/-I`` sharding, plus ``--device`` (default
``cuda``; with no GPU it raises unless ``--device cpu`` is given).  The
hmmnet half of training is not ported yet: ``-H``, ``--mmi``, ``--mpe``
and ``-M mpv`` raise `NotImplementedError`.
"""

from __future__ import annotations

import argparse
import sys

from aaltoasr_tpu_torch.cli.phone_probs import load_model
from aaltoasr_tpu_torch.device import resolve_device
from aaltoasr_tpu_torch.formats.model_io import read_model
from aaltoasr_tpu_torch.formats.recipe import Recipe
from aaltoasr_tpu_torch.train.driver import EStepDriver
from aaltoasr_tpu_torch.train.estep import later


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="stats")
    p.add_argument("-b", "--base")
    p.add_argument("-g", "--gk"), p.add_argument("-m", "--mc")
    p.add_argument("-p", "--ph")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-r", "--recipe", required=True)
    p.add_argument("-o", "--out", required=True,
                   help="output base for statistics dumps")
    p.add_argument("-M", "--mode", default="bw",
                   choices=["bw", "vit", "mpv"],
                   help="segmentation mode (mpv = multipath Viterbi, "
                        "hmmnet graphs only)")
    p.add_argument("-H", "--hmmnet", action="store_true",
                   help="use hmmnet= training networks from the recipe")
    p.add_argument("-O", "--ophn", action="store_true",
                   help="train along the fixed state-segmented "
                        "alignment= phns (stats.cc -O)")
    p.add_argument("--ml", action="store_true", default=True,
                   help="collect ML statistics (default)")
    p.add_argument("--mmi", action="store_true",
                   help="collect also MMI statistics from den-hmmnet=")
    p.add_argument("--mpe", action="store_true",
                   help="collect MPE (frame error) statistics from "
                        "den-hmmnet=")
    p.add_argument("--errmode", default="mpe",
                   choices=["mwe", "mpe", "mpfe-pdf", "mpfe-cps",
                            "mpfe", "snfe"],
                   help="MPE error mode (stats.cc:346; default mpe)")
    p.add_argument("--max-seg-dur", type=int, default=64,
                   help="duration cap for segment error modes")
    p.add_argument("--fullstats", action="store_true",
                   help="accumulate full second moments "
                        "(PDF_ML_FULL_STATS; full-covariance M-step "
                        "and MLLT)")
    p.add_argument("-t", "--transitions", action="store_true",
                   help="collect also transition statistics (always on)")
    p.add_argument("--device-batch", type=int, default=8,
                   help="utterances per device E-step call (ML path)")
    p.add_argument("-B", "--batch", type=int, default=0)
    p.add_argument("-I", "--bindex", type=int, default=0)
    p.add_argument("-i", "--info", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a GPU "
                        "unless cpu is given)")
    args = p.parse_args(argv)

    for flag, what in ((args.hmmnet, "training on hmmnet= networks (-H)"),
                       (args.mmi, "MMI statistics (--mmi)"),
                       (args.mpe, "MPE statistics (--mpe)"),
                       (args.mode == "mpv",
                        "multipath Viterbi statistics (-M mpv)")):
        if flag:
            raise later(what)
    device = resolve_device(args.device)
    model = load_model(args)
    if isinstance(model, str):
        model = read_model(model)
    driver = EStepDriver(model, args.config, mode=args.mode,
                         full_stats=args.fullstats, device=device)
    recipe = Recipe.read(args.recipe, args.batch, args.bindex)
    if args.ophn:
        stats = driver.run_recipe_aligned(recipe, info=args.info)
    elif args.fullstats or args.mode != "bw":
        stats = driver.run_recipe(recipe, info=args.info)
    else:
        stats = driver.run_recipe_batched(
            recipe, batch_size=args.device_batch, info=args.info)
    stats.dump(args.out)
    if args.info > 0:
        print(f"Total log likelihood: {stats.num_ll:.4f} over "
              f"{stats.num_frames} frames", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
