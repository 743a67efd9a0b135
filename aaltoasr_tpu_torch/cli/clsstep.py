"""clsstep: one constrained-line-search (CLS) discriminative update
step over model parameters (`aku/clsstep.cc:3150-3330`).

Reads accumulated MMI/MPE statistics and moves mixture weights and
Gaussian means/covariances toward the criterion's critical point under
KLD step-size limits.  ``--kldcs`` selects the generalized
KLD-constrained search (lambda line search per mixture/Gaussian);
default is the original CLS step.

Host copy of `aaltoasr_tpu/cli/clsstep.py`.
"""

from __future__ import annotations

import argparse
import sys

from aaltoasr_tpu_torch.formats.model_io import read_model, write_model
from aaltoasr_tpu_torch.models.hmm import TransitionTable
from aaltoasr_tpu_torch.train.accumulators import (
    HmmStats, PDF_ML_STATS, PDF_MMI_STATS, PDF_MPE_NUM_STATS)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="clsstep")
    p.add_argument("-b", "--base", required=True,
                   help="previous model base name")
    p.add_argument("-L", "--list", required=True,
                   help="file with one statistics file per line")
    p.add_argument("-o", "--out", required=True,
                   help="base filename for output models")
    p.add_argument("-M", "--mode", required=True,
                   help="optimization mode (MMI or MPE)")
    p.add_argument("--minvar", type=float, default=0.09)
    p.add_argument("--limit", type=float, default=0.1,
                   help="global KLD limit for parameter change")
    p.add_argument("--original-limits", action="store_true",
                   help="reduced KLD limits for means and covs")
    p.add_argument("--weight-kld", type=float,
                   help="KLD limit for mixture weights")
    p.add_argument("--mean-kld", type=float,
                   help="KLD limit for Gaussian means")
    p.add_argument("--cov-kld", type=float,
                   help="KLD limit for Gaussian covariances")
    p.add_argument("--kldcs", action="store_true",
                   help="generalized KLD constrained search")
    p.add_argument("--ckratio", type=float, default=0.0,
                   help="minimum criterion change/KLD ratio")
    p.add_argument("--mixture-ratio", type=float,
                   help="change/KLD ratio for mixtures")
    p.add_argument("--cov-ratio", type=float,
                   help="change/KLD ratio for covariances")
    p.add_argument("--no-write", action="store_true")
    p.add_argument("-s", "--savesum", help="save summary information")
    p.add_argument("-i", "--info", type=int, default=0)
    args = p.parse_args(argv)

    mode = args.mode.lower()
    if mode not in ("mmi", "mpe"):
        p.error(f"Invalid optimization mode: {args.mode}")
    if args.limit <= 0:
        print("The KLD limits must be greater than zero",
              file=sys.stderr)
        return 1

    weight_kld = args.weight_kld if args.weight_kld is not None \
        else args.limit
    mean_kld = args.mean_kld if args.mean_kld is not None else args.limit
    cov_kld = args.cov_kld if args.cov_kld is not None else args.limit
    if args.original_limits:
        if args.mean_kld is None:
            mean_kld = args.limit / 2.0
        if args.cov_kld is None:
            cov_kld = args.limit / 2.0
    if weight_kld <= 0 or mean_kld <= 0 or cov_kld <= 0:
        print("The KLD limits must be greater than zero",
              file=sys.stderr)
        return 1

    model = read_model(args.base)
    table = TransitionTable.from_model(model)
    smode = (PDF_ML_STATS | PDF_MMI_STATS) if mode == "mmi" \
        else PDF_MPE_NUM_STATS
    stats = HmmStats.zeros(model, table, smode)
    with open(args.list) as f:
        for line in f:
            base = line.strip()
            if base:
                stats.load(base, table)

    if args.kldcs:
        from aaltoasr_tpu_torch.train.clsstep_kld import kld_constrained_step
        new_model = kld_constrained_step(
            model, stats, mode, weight_kld_limit=weight_kld,
            mean_kld_limit=mean_kld, cov_kld_limit=cov_kld,
            min_var=args.minvar, ckratio=args.ckratio,
            mixture_ratio=args.mixture_ratio, cov_ratio=args.cov_ratio,
            info=args.info)
    else:
        from aaltoasr_tpu_torch.train.clsstep import cls_step
        new_model = cls_step(
            model, stats, mode, weight_kld_limit=weight_kld,
            mean_kld_limit=mean_kld, cov_kld_limit=cov_kld,
            min_var=args.minvar, info=args.info)

    if not args.no_write:
        write_model(args.out, new_model)
        if args.savesum:
            with open(args.savesum, "a") as f:
                f.write(f"{args.base}\n")
                f.write(f"  Numerator loglikelihood: "
                        f"{stats.num_ll:.12g}\n")
                if stats.num_frames:
                    f.write(f"  Number of frames: {stats.num_frames}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
