"""logl: total data log-likelihood given a model (`aku/logl.cc`).

Counterpart of `aaltoasr_tpu/cli/logl.py` (``-H``: the recipe's hmmnet=
networks), plus ``--device`` (default ``cuda``).
"""

from __future__ import annotations

import argparse
import sys

from aaltoasr_tpu_torch.cli.phone_probs import load_model
from aaltoasr_tpu_torch.device import resolve_device
from aaltoasr_tpu_torch.formats.model_io import read_model
from aaltoasr_tpu_torch.formats.recipe import Recipe
from aaltoasr_tpu_torch.train.driver import EStepDriver


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="logl")
    p.add_argument("-b", "--base")
    p.add_argument("-g", "--gk"), p.add_argument("-m", "--mc")
    p.add_argument("-p", "--ph")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-r", "--recipe", required=True)
    p.add_argument("-M", "--mode", default="bw", choices=["bw", "vit"],
                   help="bw = forward likelihood, vit = Viterbi")
    p.add_argument("-H", "--hmmnet", action="store_true")
    p.add_argument("-B", "--batch", type=int, default=0)
    p.add_argument("-I", "--bindex", type=int, default=0)
    p.add_argument("-i", "--info", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a GPU "
                        "unless cpu is given)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    model = load_model(args)
    if isinstance(model, str):
        model = read_model(model)
    driver = EStepDriver(model, args.config, mode=args.mode, device=device)
    recipe = Recipe.read(args.recipe, args.batch, args.bindex)
    stats = driver.run_recipe(recipe, info=args.info,
                              use_hmmnet=args.hmmnet)
    print(f"{stats.num_ll:.6f} {stats.num_frames}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
