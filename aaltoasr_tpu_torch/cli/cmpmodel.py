"""cmpmodel: compare two acoustic models (`aku/cmpmodel.cc`).

Reports per-Gaussian symmetric KL divergence summary and parameter
deltas between two models with identical structure.

Host copy of `aaltoasr_tpu/cli/cmpmodel.py`.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from aaltoasr_tpu_torch.formats.model_io import read_model


def gaussian_kl_diag(m1, c1, m2, c2) -> np.ndarray:
    """[G] KL(N1||N2) for diagonal Gaussians."""
    return 0.5 * np.sum(
        np.log(c2 / c1) + (c1 + (m1 - m2) ** 2) / c2 - 1.0, axis=1)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="cmpmodel")
    p.add_argument("base1", help="first model base")
    p.add_argument("base2", help="second model base")
    args = p.parse_args(argv)

    m1 = read_model(args.base1)
    m2 = read_model(args.base2)
    if m1.num_gaussians != m2.num_gaussians or m1.dim != m2.dim:
        print(f"models differ in structure: {m1.num_gaussians}x{m1.dim} "
              f"vs {m2.num_gaussians}x{m2.dim}")
        return 1
    kl12 = gaussian_kl_diag(m1.means, m1.covars, m2.means, m2.covars)
    kl21 = gaussian_kl_diag(m2.means, m2.covars, m1.means, m1.covars)
    skl = 0.5 * (kl12 + kl21)
    print(f"gaussians {m1.num_gaussians} dim {m1.dim}")
    print(f"symmetric KL: mean {skl.mean():.6f} max {skl.max():.6f}")
    print(f"mean abs mean-delta: "
          f"{np.abs(m1.means - m2.means).mean():.6f}")
    print(f"mean abs covar-delta: "
          f"{np.abs(m1.covars - m2.covars).mean():.6f}")
    wdelta = 0.0
    n = 0
    for (i1, w1), (i2, w2) in zip(m1.mixtures, m2.mixtures):
        if len(w1) == len(w2):
            wdelta += float(np.abs(w1 - w2).sum())
            n += len(w1)
    if n:
        print(f"mean abs weight-delta: {wdelta / n:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
