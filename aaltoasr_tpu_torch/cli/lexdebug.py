"""lexdebug: inspect the compiled lexical prefix tree
(`decoder/src/lexdebug.cc`).

Host copy of `aaltoasr_tpu/cli/lexdebug.py`.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from aaltoasr_tpu_torch.decoder.lexicon import build_prefix_tree, read_lexicon
from aaltoasr_tpu_torch.formats.model_io import read_model
from aaltoasr_tpu_torch.ops.logsemiring import LOG_ZERO


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="lexdebug")
    p.add_argument("-b", "--base", required=True, help="model base")
    p.add_argument("-l", "--lexicon", required=True)
    p.add_argument("--arcs", action="store_true",
                   help="dump every arc")
    args = p.parse_args(argv)

    model = read_model(args.base)
    tree = build_prefix_tree(model, read_lexicon(args.lexicon))
    n_arcs = int((tree.arc_logp > LOG_ZERO / 2).sum())
    n_we = int((tree.we_exit_logp > LOG_ZERO / 2).sum())
    print(f"nodes: {tree.num_nodes}")
    print(f"arcs: {n_arcs} (max fan-out "
          f"{int((tree.arc_logp > LOG_ZERO / 2).sum(1).max())})")
    print(f"word ends: {n_we}  words: {len(tree.vocab)}")
    print(f"root arcs: {len(tree.root_tgt)}")
    if args.arcs:
        for n in range(tree.num_nodes):
            for a in range(tree.arc_tgt.shape[1]):
                if tree.arc_logp[n, a] > LOG_ZERO / 2:
                    print(f"  {n} -> {tree.arc_tgt[n, a]} "
                          f"({tree.arc_logp[n, a]:.4f}) "
                          f"pdf={tree.pdf[n]}")
            for h in range(tree.we_word.shape[1]):
                if tree.we_exit_logp[n, h] > LOG_ZERO / 2:
                    w = tree.we_word[n, h]
                    name = tree.vocab[w] if w >= 0 else "_"
                    print(f"  {n} => WORD {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
