"""gcluster: cluster pool Gaussians -> .gcl file (`aku/gcluster.cc`).

Default mode mirrors the reference's diagonal KL k-means exactly
(gcluster.cc:132-291: glibc-rand initial permutation, Euclidean initial
assignment, 4 KL refinement rounds regardless of -t — the reference
hardcodes refine_clustering(4) at gcluster.cc:457).  ``--fast`` switches
to the occupancy-weighted k-means++ used by `cli/train.py` (a by-design
replacement: the clustering only gates evaluation).

Host copy of `aaltoasr_tpu/cli/gcluster.py`.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from aaltoasr_tpu_torch.formats.model_io import read_model
from aaltoasr_tpu_torch.train.gcluster import (cluster_gaussians,
                                         cluster_gaussians_ref, write_gcl)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gcluster")
    p.add_argument("-b", "--base", "-g", "--gk", dest="base",
                   required=True, help="model base name (or .gk path)")
    p.add_argument("-o", "--out", required=True, help="output .gcl file")
    p.add_argument("-C", "--clusters", type=int, default=1000)
    p.add_argument("-t", "--iterations", type=int, default=4,
                   help="refinement iterations (the reference ignores "
                        "this and always runs 4; we honor it)")
    p.add_argument("--fast", action="store_true",
                   help="occupancy-weighted k-means++ instead of the "
                        "reference algorithm")
    p.add_argument("-i", "--info", type=int, default=0)
    args = p.parse_args(argv)

    base = args.base
    if base.endswith(".gk"):
        base = base[:-3]
    model = read_model(base)
    C = min(args.clusters, model.num_gaussians)
    if args.fast:
        assign = cluster_gaussians(model.means, C)
        num = C
    else:
        assign = cluster_gaussians_ref(model.means, model.covars, C,
                                       iterations=args.iterations)
        num = int(assign.max()) + 1
    write_gcl(args.out, assign, num)
    if args.info > 0:
        print(f"clustered {model.num_gaussians} Gaussians into "
              f"{num} clusters", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
