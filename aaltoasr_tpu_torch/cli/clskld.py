"""clskld: per-parameter KL divergences between two models
(`aku/clskld.cc`): mixture-weight, Gaussian, mean-only and
covariance-only KLDs, with silence filtering — vectorized over the
pool instead of the reference's per-Gaussian loops.

Host copy of `aaltoasr_tpu/cli/clskld.py`.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from aaltoasr_tpu_torch.formats.model_io import read_model


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="clskld")
    p.add_argument("--base1", required=True,
                   help="base filename for the source model")
    p.add_argument("--base2", required=True,
                   help="base filename for the updated model")
    p.add_argument("-w", "--mixtures", action="store_true",
                   help="print KLDs of mixture weights")
    p.add_argument("-g", "--gaussians", action="store_true",
                   help="print KLDs of Gaussians")
    p.add_argument("-m", "--means", action="store_true",
                   help="print KLDs of Gaussian means")
    p.add_argument("-c", "--covs", action="store_true",
                   help="print KLDs of Gaussian covariances")
    p.add_argument("--only-silence", action="store_true")
    p.add_argument("--no-silence", action="store_true")
    args = p.parse_args(argv)

    m1 = read_model(args.base1)
    m2 = read_model(args.base2)
    if len(m1.mixtures) != len(m2.mixtures):
        print("Both models must have the same number of mixtures",
              file=sys.stderr)
        return 1
    if m1.num_gaussians != m2.num_gaussians:
        print("Both models must have the same number of Gaussians",
              file=sys.stderr)
        return 1

    mix_flag = np.ones(len(m1.mixtures), bool)
    g_flag = np.ones(m1.num_gaussians, bool)
    if args.only_silence or args.no_silence:
        mix_flag[:] = False
        g_flag[:] = False
        for ph in m1.phones:
            is_sil = (ph.label.startswith("_") and "-" not in ph.label
                      and "+" not in ph.label)
            keep = is_sil if args.only_silence else not is_sil
            if keep:
                for s in ph.states:
                    mix_flag[s] = True
                    g_flag[np.asarray(m1.mixtures[s][0])] = True

    if args.mixtures:
        for s, ((i1, w1), (i2, w2)) in enumerate(
                zip(m1.mixtures, m2.mixtures)):
            if not mix_flag[s] or len(w1) != len(w2):
                continue
            w1 = np.maximum(np.asarray(w1), 1e-300)
            w2 = np.maximum(np.asarray(w2), 1e-300)
            print(f"{float(np.sum(w2 * np.log(w2 / w1))):g}")

    c1 = np.maximum(m1.covars, 1e-300)
    c2 = np.maximum(m2.covars, 1e-300)
    d = m2.means - m1.means
    D = m1.dim
    if args.gaussians:
        kld = 0.5 * ((d * d / c1).sum(1)
                     + (c2 / c1 + np.log(c1 / c2)).sum(1) - D)
        for i in np.nonzero(g_flag)[0]:
            print(f"{kld[i]:g}")
    if args.means:
        kld = 0.5 * (d * d / c1).sum(1)
        for i in np.nonzero(g_flag)[0]:
            print(f"{kld[i]:g}")
    if args.covs:
        kld = 0.5 * ((c2 / c1 + np.log(c1 / c2)).sum(1) - D)
        for i in np.nonzero(g_flag)[0]:
            print(f"{kld[i]:g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
