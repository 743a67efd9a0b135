"""estimate: the M-step — statistics dumps -> new model
(`aku/estimate.cc:108-430`).

Supported: ``--ml`` with ``--minvar`` (default 0.1), ``--mixture-minweight``,
``--no-mixture-update``, ``--no-transition-update``, ``-s`` summary, and
the EBW discriminative modes ``--mmi``/``--mpe`` with ``--C1/--C2`` and
``--ismooth`` (train.ebw).

Host copy of `aaltoasr_tpu/cli/estimate.py`.
"""

from __future__ import annotations

import argparse
import sys

from aaltoasr_tpu_torch.formats.model_io import read_model, write_model
from aaltoasr_tpu_torch.models.hmm import TransitionTable
from aaltoasr_tpu_torch.train.accumulators import HmmStats
from aaltoasr_tpu_torch.train.estimate import estimate_ml


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="estimate")
    p.add_argument("-b", "--base", required=True, help="input model base")
    p.add_argument("-L", "--list", required=True,
                   help="file with one statistics base name per line")
    p.add_argument("-o", "--out", required=True, help="output model base")
    p.add_argument("--ml", action="store_true", help="ML estimation")
    p.add_argument("--mmi", action="store_true",
                   help="maximum mutual information estimation")
    p.add_argument("--mpe", action="store_true",
                   help="minimum phone (frame) error estimation")
    p.add_argument("--C1", type=float, default=2.0,
                   help='constant "C1" for EBW updates (default 2.0)')
    p.add_argument("--C2", type=float, default=2.0,
                   help='constant "C2" for EBW updates (default 2.0)')
    p.add_argument("--ismooth", type=float, default=0.0,
                   help="I-smoothing tau for EBW updates")
    p.add_argument("--limit", type=float, default=0.0,
                   help="global KLD limit for parameter change "
                        "(constrained EBW)")
    p.add_argument("--minvar", type=float, default=0.1,
                   help="minimum variance (default 0.1)")
    p.add_argument("--mixture-minweight", type=float, default=0.0)
    p.add_argument("--no-mixture-update", action="store_true")
    p.add_argument("--split", action="store_true",
                   help="Enable Gaussian splitting")
    p.add_argument("--delete", type=float,
                   help="delete Gaussians with occupancy below this")
    p.add_argument("--mremove", type=float,
                   help="remove mixture components below this weight")
    p.add_argument("--minocc", type=float, default=0.0,
                   help="Occupancy threshold for Gaussian splitting")
    p.add_argument("--maxmixgauss", type=int, default=2**30,
                   help="Maximum Gaussians per mixture")
    p.add_argument("--numgauss", type=int, default=-1,
                   help="Target number of Gaussians in the final model")
    p.add_argument("--splitalpha", type=float, default=1.0,
                   help="Occupancy smoothing power for splitting")
    p.add_argument("--no-transition-update", action="store_true")
    p.add_argument("-D", "--ebwd",
                   help="read Gaussian specific EBW D values (and limits)")
    p.add_argument("--write-ebwd",
                   help="write Gaussian specific D and minimum D values")
    p.add_argument("-s", "--summary", help="write summary file here")
    p.add_argument("-i", "--info", type=int, default=0)
    args = p.parse_args(argv)

    from aaltoasr_tpu_torch.train.accumulators import (
        PDF_ML_STATS, PDF_MMI_STATS)
    model = read_model(args.base)
    table = TransitionTable.from_model(model)
    from aaltoasr_tpu_torch.train.accumulators import (
        PDF_MPE_DEN_STATS, PDF_MPE_NUM_STATS)
    mode = (PDF_ML_STATS | (PDF_MMI_STATS if args.mmi else 0)
            | ((PDF_MPE_NUM_STATS | PDF_MPE_DEN_STATS)
               if args.mpe else 0))
    stats = HmmStats.zeros(model, table, mode)
    with open(args.list) as f:
        for line in f:
            base = line.strip()
            if base:
                stats.load(base, table)

    # --ebwd: per-Gaussian fixed D values "D [min max]" per line
    # (estimate.cc:28-77); min/max columns are read but, as in the
    # reference, only D feeds the update
    fixed_d = None
    ebwd_min = ebwd_max = None
    if args.ebwd:
        import numpy as np
        G = model.num_gaussians
        fixed_d = np.full(G, -1.0)
        ebwd_min = np.full(G, -1.0)
        ebwd_max = np.full(G, -1.0)
        with open(args.ebwd) as f:
            for i in range(G):
                fields = f.readline().split()
                if not fields:
                    raise ValueError("Failed to read D values")
                fixed_d[i] = max(float(fields[0]), 0.0)
                if len(fields) >= 3:
                    ebwd_min[i] = float(fields[1])
                    ebwd_max[i] = float(fields[2])

    d_out: dict = {}
    if args.mmi or args.mpe:
        from aaltoasr_tpu_torch.train.ebw import estimate_mmi
        new_model = estimate_mmi(
            model, table, stats, c1=args.C1, c2=args.C2,
            tau=args.ismooth, minvar=args.minvar,
            mode="mpe" if args.mpe else "mmi", max_kld=args.limit,
            update_mixtures=not args.no_mixture_update,
            fixed_d=fixed_d, d_out=d_out)
    else:
        new_model = estimate_ml(
            model, table, stats, minvar=args.minvar,
            mixture_minweight=args.mixture_minweight,
            update_mixtures=not args.no_mixture_update,
            update_transitions=not args.no_transition_update)
    if args.delete is not None:
        from aaltoasr_tpu_torch.train.split import delete_gaussians
        new_model, n = delete_gaussians(new_model, stats, args.delete)
        if args.info > 0:
            print(f"Deleted {n} Gaussians", file=sys.stderr)
    if args.mremove is not None:
        from aaltoasr_tpu_torch.train.split import remove_mixture_components
        new_model, n = remove_mixture_components(new_model, args.mremove)
        if args.info > 0:
            print(f"Removed {n} mixture components", file=sys.stderr)
    if args.split:
        from aaltoasr_tpu_torch.train.split import split_gaussians
        new_model, n = split_gaussians(
            new_model, stats, minocc=args.minocc, maxg=args.maxmixgauss,
            numgauss=args.numgauss, splitalpha=args.splitalpha)
        if args.info > 0:
            print(f"Split {n} Gaussians", file=sys.stderr)
    write_model(args.out, new_model)

    if args.write_ebwd:
        # realized D + max(min D, file min), min(realized, file max)
        # semantics of write_ebw_d_file (estimate.cc:79-102)
        import numpy as np
        G = model.num_gaussians
        realized = d_out.get("realized_d")
        min_d = d_out.get("min_d")
        if realized is None:
            realized = np.full(G, -1.0)
            min_d = np.full(G, -1.0)
        out_min = min_d.copy()
        out_max = realized.copy()
        if ebwd_min is not None:
            out_min = np.maximum(out_min, ebwd_min)
            out_max = np.where(
                (ebwd_max > 0) & ~(out_max < ebwd_max), ebwd_max, out_max)
        with open(args.write_ebwd, "w") as f:
            for v, mn, mx in zip(realized, out_min, out_max):
                f.write(f"{v:g} {mn:g} {mx:g}\n")

    if args.summary:
        with open(args.summary, "a") as f:
            f.write(f"{args.out} numerator loglikelihood "
                    f"{stats.num_ll:.6g} frames {stats.num_frames}\n")
    if args.info > 0:
        print(f"Log likelihood: {stats.num_ll:.4f}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
