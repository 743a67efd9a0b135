"""lna: dump LNA file contents (`decoder/src/lna.cc`).

Host copy of `aaltoasr_tpu/cli/lna_tool.py`.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from aaltoasr_tpu_torch.formats.lna import read_lna


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="lna")
    p.add_argument("file", help="LNA file")
    p.add_argument("-n", "--frames", type=int, default=-1,
                   help="print only the first N frames")
    p.add_argument("--argmax", action="store_true",
                   help="print only the best state per frame")
    args = p.parse_args(argv)

    lp, nbytes = read_lna(args.file)
    print(f"# {lp.shape[1]} states, {lp.shape[0]} frames, "
          f"{nbytes} bytes/prob", file=sys.stderr)
    T = lp.shape[0] if args.frames < 0 else min(args.frames, lp.shape[0])
    for t in range(T):
        if args.argmax:
            b = int(np.argmax(lp[t]))
            print(f"{t} {b} {lp[t, b]:.4f}")
        else:
            print(" ".join(f"{v:.4f}" for v in lp[t]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
