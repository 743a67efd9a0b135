"""combine_stats: merge statistics dumps (`aku/combine_stats.cc:17`).

Usage: combine_stats -b model_base -o out_base -F list_file
where list_file has one dump base name per line.

Host copy of `aaltoasr_tpu/cli/combine_stats.py`.
"""

from __future__ import annotations

import argparse
import sys

from aaltoasr_tpu_torch.formats.model_io import read_model
from aaltoasr_tpu_torch.models.hmm import TransitionTable
from aaltoasr_tpu_torch.train.accumulators import HmmStats


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="combine_stats")
    p.add_argument("-b", "--base", required=True, help="model base name")
    p.add_argument("-L", "--list", required=True,
                   help="file with one statistics base name per line")
    p.add_argument("-o", "--out", required=True, help="output base")
    args = p.parse_args(argv)

    model = read_model(args.base)
    table = TransitionTable.from_model(model)
    total = HmmStats.zeros(model, table)
    with open(args.list) as f:
        for line in f:
            base = line.strip()
            if base:
                total.load(base, table)
    total.dump(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
