"""arpa2bin: compile an ARPA LM to binary TreeGram
(`decoder/src/arpa2bin.cc`)."""

from __future__ import annotations

import argparse
import sys

from aaltoasr_tpu_torch.formats.arpa import read_arpa
from aaltoasr_tpu_torch.formats.treegram_bin import write_bin


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="arpa2bin")
    p.add_argument("arpa", help="input ARPA file")
    p.add_argument("bin", help="output binary LM")
    p.add_argument("-i", "--interpolated", action="store_true")
    args = p.parse_args(argv)
    lm = read_arpa(args.arpa)
    write_bin(lm, args.bin,
              "interpolated" if args.interpolated else "backoff")
    return 0


if __name__ == "__main__":
    sys.exit(main())
