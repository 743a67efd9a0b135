"""optmodel: gradient-based discriminative model optimization
(`aku/optmodel.cc` + `aku/LmbfgsOptimize.cc`).

One invocation = one optimization iteration: load the model and fresh
statistics dumps, form the weighted ML/MMI/MPE criterion gradient,
take a limited-memory-BFGS ascent step (history carried in the -F
optimization state file between invocations), and write the new model.

Host copy of `aaltoasr_tpu/cli/optmodel.py`.
"""

from __future__ import annotations

import argparse
import os
import sys

from aaltoasr_tpu_torch.cli.phone_probs import load_model
from aaltoasr_tpu_torch.formats.model_io import read_model, write_model
from aaltoasr_tpu_torch.models.hmm import TransitionTable
from aaltoasr_tpu_torch.train.accumulators import (
    HmmStats, PDF_ML_STATS, PDF_MMI_STATS, PDF_MPE_DEN_STATS,
    PDF_MPE_NUM_STATS)
from aaltoasr_tpu_torch.train.optimize import (
    LbfgsState, criterion_grad, optimization_step, pack_params,
    unpack_params)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="optmodel")
    p.add_argument("-b", "--base")
    p.add_argument("-g", "--gk"), p.add_argument("-m", "--mc")
    p.add_argument("-p", "--ph")
    p.add_argument("-L", "--list", required=True,
                   help="file with one statistics base per line")
    p.add_argument("-F", "--osf", required=True,
                   help="optimization state file")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--ml", type=float, default=0.0,
                   help="ML optimization weight")
    p.add_argument("--mmi", type=float, default=0.0,
                   help="MMI optimization weight")
    p.add_argument("--mpe", type=float, default=0.0,
                   help="MPE optimization weight")
    p.add_argument("--gsmooth", type=float, default=0.0,
                   help="MPE Gaussian ML smoothing")
    p.add_argument("--msmooth", type=float, default=0.0,
                   help="MPE mixture ML smoothing")
    p.add_argument("-l", "--initscale", type=float, default=1.0,
                   help="initialize with inverse Hessian scale")
    p.add_argument("--minvar", type=float, default=0.09)
    p.add_argument("--limit", type=float, default=1.0,
                   help="limit parameter change")
    p.add_argument("--bfgsu", type=int, default=4,
                   help="number of BFGS updates")
    p.add_argument("-s", "--savesum", help="save summary here")
    p.add_argument("-i", "--info", type=int, default=0)
    args = p.parse_args(argv)

    if not (args.ml or args.mmi or args.mpe):
        print("optmodel: give at least one of --ml/--mmi/--mpe",
              file=sys.stderr)
        return 1
    model = load_model(args)
    if isinstance(model, str):
        model = read_model(model)
    table = TransitionTable.from_model(model)
    mode = (PDF_ML_STATS
            | (PDF_MMI_STATS if args.mmi else 0)
            | ((PDF_MPE_NUM_STATS | PDF_MPE_DEN_STATS)
               if args.mpe else 0))
    stats = HmmStats.zeros(model, table, mode)
    with open(args.list) as f:
        for line in f:
            base = line.strip()
            if base:
                stats.load(base, table)

    grad = criterion_grad(model, stats, ml_weight=args.ml,
                          mmi_weight=args.mmi, mpe_weight=args.mpe,
                          gsmooth=args.gsmooth, msmooth=args.msmooth)
    x = pack_params(model)
    if os.path.exists(args.osf):
        state = LbfgsState.load(args.osf)
    else:
        state = LbfgsState(max_updates=args.bfgsu,
                           init_scale=args.initscale)
    x_new = optimization_step(x, grad, state, limit=args.limit)
    state.save(args.osf)
    write_model(args.out, unpack_params(model, x_new,
                                        minvar=args.minvar))

    score = (args.ml * stats.num_ll
             + args.mmi * (stats.num_ll - stats.den_ll)
             + args.mpe * stats.den_ll)   # den_ll carries avg accuracy
    if args.savesum:
        with open(args.savesum, "a") as f:
            f.write(f"{args.out} criterion {score:.6g} gradnorm "
                    f"{float((grad * grad).sum()) ** 0.5:.6g}\n")
    if args.info > 0:
        print(f"criterion {score:.4f}  |grad| "
              f"{float((grad * grad).sum()) ** 0.5:.4f}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
