"""bin2arpa: decompile a binary TreeGram LM to ARPA
(`decoder/src/bin2arpa.cc`)."""

from __future__ import annotations

import argparse
import sys

from aaltoasr_tpu_torch.formats.arpa import write_arpa
from aaltoasr_tpu_torch.formats.treegram_bin import read_bin


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="bin2arpa")
    p.add_argument("bin", help="input binary LM")
    p.add_argument("arpa", help="output ARPA file")
    args = p.parse_args(argv)
    write_arpa(read_bin(args.bin), args.arpa)
    return 0


if __name__ == "__main__":
    sys.exit(main())
