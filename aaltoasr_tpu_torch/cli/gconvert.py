"""gconvert: convert Gaussian covariance types (`aku/gconvert.cc`).

Used by train.pl after tying to turn the full-covariance initial model
diagonal (train.pl:222-229).

Host copy of `aaltoasr_tpu/cli/gconvert.py`.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from aaltoasr_tpu_torch.formats.model_io import read_model, write_model


def _gauss_cov(model, g) -> np.ndarray:
    if g in model.full_covars:
        return np.asarray(model.full_covars[g], np.float64)
    return np.diag(model.covars[g])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gconvert")
    p.add_argument("-b", "--base", required=True, help="input model base")
    p.add_argument("-o", "--out", required=True, help="output model base")
    p.add_argument("-d", "--diagonal", action="store_true",
                   help="convert to diagonal covariances")
    p.add_argument("-f", "--full", action="store_true",
                   help="convert to full covariances")
    p.add_argument("-p", "--to-pcgmm", action="store_true",
                   help="constrain precisions to a shared subspace "
                        "(gconvert.cc:26)")
    p.add_argument("-s", "--to-scgmm", action="store_true",
                   help="constrain exponential parameters to a shared "
                        "subspace (gconvert.cc:27)")
    p.add_argument("--ssdim", type=int, default=0,
                   help="subspace dimensionality")
    p.add_argument("--subspace", default="",
                   help="use an already initialized subspace file")
    p.add_argument("-i", "--info", type=int, default=0)
    args = p.parse_args(argv)

    model = read_model(args.base)
    if args.diagonal:
        # covars already hold the diagonal (model_io extracts it on read)
        model.cov_type = "diagonal_cov"
        model.full_covars = {}
        model.gauss_kind = ["diag"] * model.num_gaussians
        model.pcgmm_params = {}
        model.scgmm_params = {}
        model.precision_subspaces = {}
        model.exponential_subspaces = {}
    elif args.full:
        model.cov_type = "full_cov"
        model.full_covars = {
            g: _gauss_cov(model, g)
            for g in range(model.num_gaussians)}
        model.gauss_kind = ["full"] * model.num_gaussians
        model.pcgmm_params = {}
        model.scgmm_params = {}
        model.precision_subspaces = {}
        model.exponential_subspaces = {}
    elif args.to_pcgmm:
        from aaltoasr_tpu_torch.ops.subspaces import PrecisionSubspace
        G = model.num_gaussians
        covs = [_gauss_cov(model, g) for g in range(G)]
        if args.subspace:
            with open(args.subspace) as f:
                ps = PrecisionSubspace.read(iter(f.read().split()))
        else:
            if args.ssdim <= 0:
                p.error("--ssdim must be positive without --subspace")
            if args.info > 0:
                print("Initializing the precision subspace",
                      file=sys.stderr)
            ps = PrecisionSubspace.initialize_pca(
                np.ones(G), covs, args.ssdim)
        model.precision_subspaces = {1: ps}
        model.exponential_subspaces = {}
        model.scgmm_params = {}
        model.pcgmm_params = {}
        for g in range(G):
            if args.info > 1:
                print(f"pcgmm coefficients for gaussian {g}",
                      file=sys.stderr)
            lam = ps.optimize_coefficients(covs[g])
            P = ps.compute_precision(lam)
            tm = P @ model.means[g]
            model.pcgmm_params[g] = (1, tm, lam)
        model.cov_type = "variable"
        model.gauss_kind = ["pcgmm"] * G
        model.full_covars = {}
    elif args.to_scgmm:
        from aaltoasr_tpu_torch.ops.subspaces import ExponentialSubspace
        G = model.num_gaussians
        covs = [_gauss_cov(model, g) for g in range(G)]
        means = [model.means[g] for g in range(G)]
        if args.subspace:
            with open(args.subspace) as f:
                es = ExponentialSubspace.read(iter(f.read().split()))
        else:
            if args.ssdim <= 0:
                p.error("--ssdim must be positive without --subspace")
            if args.info > 0:
                print("Initializing the exponential subspace",
                      file=sys.stderr)
            es = ExponentialSubspace.initialize_pca(
                np.ones(G), covs, means, args.ssdim)
        model.exponential_subspaces = {1: es}
        model.precision_subspaces = {}
        model.pcgmm_params = {}
        model.scgmm_params = {}
        for g in range(G):
            if args.info > 1:
                print(f"scgmm coefficients for gaussian {g}",
                      file=sys.stderr)
            lam = es.optimize_coefficients(means[g], covs[g])
            model.scgmm_params[g] = (1, lam)
        model.cov_type = "variable"
        model.gauss_kind = ["scgmm"] * G
        model.full_covars = {}
    write_model(args.out, model)
    return 0


if __name__ == "__main__":
    sys.exit(main())
