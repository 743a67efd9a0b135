"""feadot: dump the feature DAG as a DOT graph (`aku/feadot.cc`).

Counterpart of `aaltoasr_tpu/cli/feadot.py`, plus ``--device`` (default
``cuda``; the generator's tables are made there).
"""

from __future__ import annotations

import argparse
import sys

from aaltoasr_tpu_torch.frontend.generator import FeatureGenerator


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="feadot")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a GPU "
                        "unless cpu is given)")
    args = p.parse_args(argv)
    FeatureGenerator(args.config, device=args.device).print_dot_graph(
        sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
