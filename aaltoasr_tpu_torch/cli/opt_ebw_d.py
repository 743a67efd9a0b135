"""opt_ebw_d: optimize per-Gaussian EBW D constants with QuickProp

Host copy of `aaltoasr_tpu/cli/opt_ebw_d.py`.
against a control-set criterion (`aku/opt_ebw_d.cc`).

Same flags/flow as the reference: reads control (-L) and training (-T)
statistics dump lists, extracts the D gradient, performs a gradient
(--initscale) or QuickProp step, and writes the Gaussian D file
(--gauss-out), optional cluster D file (--cluster-d) and the binary
optimization state (-F).  ``--d-init`` only realizes and writes the
Gaussian D file.  Exits 1 when converged (update 2-norm < 1e-3).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from aaltoasr_tpu_torch.formats.model_io import read_model
from aaltoasr_tpu_torch.models.hmm import TransitionTable
from aaltoasr_tpu_torch.train import opt_ebw_d as od
from aaltoasr_tpu_torch.train.accumulators import (
    HmmStats, PDF_ML_STATS, PDF_MMI_STATS, PDF_MPE_NUM_STATS,
    PDF_MPE_DEN_STATS)


def _stats_mode(criterion: str, mpe_gradient: bool) -> int:
    if criterion == "ml":
        return PDF_ML_STATS
    if criterion == "mmi":
        return PDF_ML_STATS | PDF_MMI_STATS
    mode = PDF_MPE_NUM_STATS
    if not mpe_gradient:
        mode |= PDF_MPE_DEN_STATS
    return mode


def _load_stats(model, table, list_path, mode) -> HmmStats:
    stats = HmmStats.zeros(model, table, mode)
    with open(list_path) as f:
        for line in f:
            base = line.strip()
            if base:
                stats.load(base, table)
    return stats


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="opt_ebw_d")
    p.add_argument("-b", "--base", required=True,
                   help="model base name (.gk/.mc/.ph)")
    p.add_argument("-L", "--list", required=True,
                   help="development (control) set statistics list")
    p.add_argument("-T", "--tstats", required=True,
                   help="training set statistics list")
    p.add_argument("-F", "--osf", required=True,
                   help="optimization state file")
    p.add_argument("-D", "--ebwd", default="",
                   help="input Gaussian D values and limits")
    p.add_argument("-o", "--gauss-out", required=True,
                   help="output Gaussian D file")
    p.add_argument("--cluster-d", default="",
                   help="input/output clustered D file")
    p.add_argument("--control", required=True,
                   choices=["ml", "mmi", "mpe"])
    p.add_argument("--train", required=True, choices=["ml", "mmi", "mpe"])
    p.add_argument("--grad", action="store_true",
                   help="gradient-based MPE statistics")
    p.add_argument("--cluster", choices=["global", "pho", "mix"])
    p.add_argument("--qp-eps", type=float, default=0.02)
    p.add_argument("-l", "--initscale", type=float,
                   help="initial gradient step size")
    p.add_argument("-I", "--d-init", action="store_true",
                   help="initialize Gaussian D file and exit")
    p.add_argument("-P", "--prior", type=float, default=0.0)
    p.add_argument("--gmin", type=float,
                   help="relaxed Gaussian-D minimum multiplier")
    p.add_argument("-A", "--ac-scale", type=float, default=1.0)
    p.add_argument("-s", "--savesum", help="append summary here")
    p.add_argument("-i", "--info", type=int, default=0)
    args = p.parse_args(argv)

    cluster_mode = args.cluster or "none"
    if cluster_mode != "none" and not args.cluster_d:
        p.error("Clustering requires --cluster-d")
    relaxed = args.gmin is not None
    gmin_gamma = args.gmin if relaxed else 0.0

    model = read_model(args.base)
    table = TransitionTable.from_model(model)
    G = model.num_gaussians
    cluster = od.gaussian_clusters(model, cluster_mode)
    n_params = (int(cluster.max()) + 1) if G else 0

    # ---- D values and limits (set_optimization_parameters)
    gaussian_min_d = np.zeros(G)
    gaussian_max_d = np.full(G, -1.0)
    gaussian_d = np.zeros(G)
    if args.ebwd:
        gaussian_d, gaussian_min_d, gaussian_max_d = od.read_d_file(
            args.ebwd, G)
    from_gaussians = True
    d_params = param_min_d = param_max_d = None
    if args.cluster_d:
        try:
            d_params, param_min_d, param_max_d = od.read_d_file(
                args.cluster_d, n_params)
            from_gaussians = False
        except OSError:
            pass
    if from_gaussians:
        if not args.ebwd:
            p.error("need --ebwd to initialize cluster D values")
        print("Initializing clustered D's from Gaussian D's",
              file=sys.stderr)
        d_params, param_min_d, param_max_d = (
            od.init_cluster_d_from_gaussians(
                cluster, n_params, gaussian_d, gaussian_min_d,
                gaussian_max_d))
        gaussian_d = od.realize_gaussian_d(
            d_params, cluster, gaussian_min_d, gaussian_max_d,
            relaxed, gmin_gamma)

    if args.d_init:
        gaussian_d = od.realize_gaussian_d(
            d_params, cluster, gaussian_min_d, gaussian_max_d,
            relaxed, gmin_gamma)
        od.write_d_file(args.gauss_out, gaussian_d, gaussian_min_d,
                        gaussian_max_d)
        return 0

    prev = None
    if args.initscale is None:
        prev = od.read_qp_state(args.osf)
        if prev is None:
            print(f"Could not read {args.osf}, start optimization with "
                  "--initscale", file=sys.stderr)
            return 1

    # ---- statistics
    control_stats = _load_stats(model, table, args.list,
                                _stats_mode(args.control, args.grad))
    train_stats = _load_stats(model, table, args.tstats,
                              _stats_mode(args.train, args.grad))

    # ---- score (for summaries; QP itself only uses gradients)
    if args.control == "mpe":
        score = -control_stats.mpe_score
    elif args.control == "mmi":
        score = -(control_stats.num_ll - control_stats.den_ll)
    else:
        score = -control_stats.num_ll

    ggrad = od.gauss_gradient(
        model, control_stats, train_stats, gaussian_d, args.ac_scale,
        args.control, args.train, args.grad)
    gradient, n_disc = od.combine_gradient(
        ggrad, cluster, d_params, gaussian_d, gaussian_min_d,
        gaussian_max_d, param_min_d, param_max_d, relaxed, gmin_gamma,
        args.prior)
    for g, dv in zip(gradient, d_params):
        print(f"{g:g} {dv:g}")

    converged = False
    if args.initscale is not None:
        if args.initscale > 0:
            d_params, prev_step = od.gradient_step(
                d_params, gradient, param_min_d, param_max_d,
                args.initscale)
        else:
            prev_step = np.zeros_like(d_params)
    else:
        prev_step, prev_gradient = prev
        d_params, prev_step, converged = od.qp_step(
            d_params, gradient, prev_step, prev_gradient,
            param_min_d, param_max_d, args.qp_eps)

    if not converged:
        gaussian_d = od.realize_gaussian_d(
            d_params, cluster, gaussian_min_d, gaussian_max_d,
            relaxed, gmin_gamma)
        od.write_d_file(args.gauss_out, gaussian_d, gaussian_min_d,
                        gaussian_max_d)
        if args.cluster_d:
            od.write_d_file(args.cluster_d, d_params, param_min_d,
                            param_max_d)
        od.write_qp_state(args.osf, prev_step, gradient)

    if args.savesum:
        with open(args.savesum, "a") as f:
            f.write(f"{args.base}\n")
            f.write(f"  Number of frames: {control_stats.num_frames}\n")
            f.write(f"  Numerator loglikelihood: "
                    f"{control_stats.num_ll:.12g}\n")

    print(f"score: {score:.3f}", file=sys.stderr)
    print(f"Discarded Gaussians: {n_disc}", file=sys.stderr)
    return 1 if converged else 0


if __name__ == "__main__":
    sys.exit(main())
