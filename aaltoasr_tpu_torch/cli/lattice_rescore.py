"""lattice_rescore: expand+rescore SLF lattices with a new LM
(`tools/lattice_rescore/lattice_rescore.cc`)."""

from __future__ import annotations

import argparse
import sys

from aaltoasr_tpu_torch.decoder.slf import SlfLattice
from aaltoasr_tpu_torch.formats.arpa import read_arpa
from aaltoasr_tpu_torch.formats.treegram_bin import read_bin


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="lattice_rescore")
    p.add_argument("-l", "--lm", required=True,
                   help="new language model (ARPA or binary)")
    p.add_argument("--mix", action="append", nargs=2, default=[],
                   metavar=("FILE", "COEFF"),
                   help="interpolate another LM with this coefficient "
                        "(repeatable; InterTreeGram)")
    p.add_argument("-b", "--binary", action="store_true",
                   help="LM is binary TreeGram")
    p.add_argument("-o", "--out", help="output lattice (default stdout)")
    p.add_argument("--best", action="store_true",
                   help="print the 1-best path of the rescored lattice")
    p.add_argument("--lm-scale", type=float, default=None,
                   help="override lattice lmscale")
    p.add_argument("lattice", help="input SLF lattice")
    args = p.parse_args(argv)

    lm = read_bin(args.lm) if args.binary else read_arpa(args.lm)
    if args.mix:
        from aaltoasr_tpu_torch.decoder.intergram import InterTreeGram
        extra = [(read_bin(f) if f.endswith(".bin") else read_arpa(f),
                  float(c)) for f, c in args.mix]
        coeffs = ([1.0 - sum(c for _, c in extra)]
                  + [c for _, c in extra])
        lm = InterTreeGram([lm] + [m for m, _ in extra], coeffs)
    lat = SlfLattice.read(args.lattice)
    if args.lm_scale is not None:
        lat.lm_scale = args.lm_scale
    out = lat.rescore(lm)
    if args.out:
        out.write(args.out)
    elif not args.best:
        out.write(sys.stdout)
    if args.best:
        words, score = out.best_path()
        print(f"{' '.join(words)} ({score:.4f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
