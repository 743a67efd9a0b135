"""phone_probs: recipe -> per-utterance LNA emission probability files.

Counterpart of `aaltoasr_tpu/cli/phone_probs.py`, with the same flags
(`aku/phone_probs.cc:46-110`: speaker configurations -S, Gaussian
clustering -C with --eval-minc/--eval-ming, --sort-recipe), plus
``--device`` (default ``cuda``; with no GPU it raises unless ``--device
cpu`` is given).
"""

from __future__ import annotations

import argparse
import sys

from aaltoasr_tpu_torch.device import resolve_device
from aaltoasr_tpu_torch.formats.model_io import (
    HmmModel, read_gk, read_mc, read_ph)
from aaltoasr_tpu_torch.formats.recipe import Recipe
from aaltoasr_tpu_torch.models.phone_probs import PhoneProbs
from aaltoasr_tpu_torch.utils.profiling import device_trace


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="phone_probs", description="Generate LNA files for a recipe")
    p.add_argument("-b", "--base", help="base filename for model files")
    p.add_argument("-g", "--gk", help="Gaussian kernels")
    p.add_argument("-m", "--mc", help="kernel indices for states")
    p.add_argument("-p", "--ph", help="HMM definitions")
    p.add_argument("-c", "--config", required=True,
                   help="feature configuration")
    p.add_argument("-r", "--recipe", required=True, help="recipe file")
    p.add_argument("-o", "--output-dir", default="",
                   help="output directory (default: filenames from recipe)")
    p.add_argument("--lnabytes", type=int, default=2,
                   help="bytes per probability, 2 (default) or 4")
    p.add_argument("-a", "--afname", action="store_true",
                   help="use audio file name")
    p.add_argument("-n", "--no-overwrite", action="store_true",
                   help="prevent overwriting existing files")
    p.add_argument("-S", "--speakers", help="speaker configuration file")
    p.add_argument("-C", "--clusters", help="Gaussian clustering file")
    p.add_argument("--eval-minc", type=float, default=0.0)
    p.add_argument("--eval-ming", type=float, default=0.1)
    p.add_argument("--sort-recipe", action="store_true",
                   help="sort recipe lines, useful with adaptation")
    p.add_argument("-N", "--no-normalization", action="store_true",
                   help="do not normalize the likelihoods")
    p.add_argument("-B", "--batch", type=int, default=0,
                   help="number of batch processes with the same recipe")
    p.add_argument("-I", "--bindex", type=int, default=0,
                   help="batch process index")
    p.add_argument("-i", "--info", type=int, default=0, help="info level")
    p.add_argument("--fused", action="store_true",
                   help="run the MFCC core and the state scoring as fused "
                        "kernels (ops/frontend_cuda.py, ops/gmm_cuda.py; "
                        "deltas below the 2-byte quantization step; plain "
                        "diagonal GMMs, no -C clustering)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a GPU "
                        "unless cpu is given)")
    return p


def load_model(args) -> HmmModel | str:
    if args.base:
        return args.base
    if args.gk and args.mc and args.ph:
        means, covars, cov_type, kind, full, _ss = read_gk(args.gk)
        mixtures = read_mc(args.mc)
        phones, transitions = read_ph(args.ph)
        return HmmModel(dim=means.shape[1], cov_type=cov_type, means=means,
                        covars=covars, full_covars=full, gauss_kind=kind,
                        mixtures=mixtures, phones=phones,
                        transitions=transitions)
    raise SystemExit("Must give either --base or all --gk, --mc and --ph")


@device_trace()
def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    pp = PhoneProbs(load_model(args), args.config,
                    lna_bytes=args.lnabytes,
                    normalize=not args.no_normalization,
                    fused=args.fused, device=device)
    if args.speakers:
        pp.read_speaker_config(args.speakers)
    if args.clusters:
        pp.read_clustering(args.clusters, args.eval_minc,
                           args.eval_ming)
    recipe = Recipe.read(args.recipe, args.batch, args.bindex)
    if args.sort_recipe:
        recipe.sort_by_speaker()
    pp.generate_recipe(recipe, out_dir=args.output_dir,
                       use_audio_fname=args.afname,
                       no_overwrite=args.no_overwrite, info=args.info)
    return 0


if __name__ == "__main__":
    sys.exit(main())
