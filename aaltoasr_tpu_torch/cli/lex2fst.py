"""lex2fst: lexicon -> phone-level FST with word outputs
(`aku/scripts/lex2fst.pl`).

Words become parallel phone paths between a shared start/end with the
word emitted on the first arc; an optional silence loop closes the
network.  Output is MIT-FST ASCII for the hmmnet composition pipeline.

Host copy of `aaltoasr_tpu/cli/lex2fst.py`.
"""

from __future__ import annotations

import argparse
import sys

from aaltoasr_tpu_torch.decoder.lexicon import read_lexicon
from aaltoasr_tpu_torch.formats.fst import Fst, FstArc, write_fst


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="lex2fst")
    p.add_argument("lexicon", help="NOWAY lexicon file")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--no-loop", action="store_true",
                   help="do not loop end back to start")
    args = p.parse_args(argv)

    entries = read_lexicon(args.lexicon)
    fst = Fst()
    start, end = 0, 1
    fst.num_nodes = 2
    nxt = [2]

    def node():
        n = nxt[0]
        nxt[0] += 1
        fst.num_nodes = max(fst.num_nodes, n + 1)
        return n

    import math
    for e in entries:
        cur = start
        for i, ph in enumerate(e.phones):
            tgt = end if i == len(e.phones) - 1 else node()
            score = math.log(e.prob) if (i == 0 and e.prob > 0
                                         and e.prob != 1.0) else 0.0
            fst.add_arc(FstArc(cur, tgt, label=ph,
                               out_label=e.word if i == 0 else "",
                               score=score))
            cur = tgt
    if not args.no_loop:
        fst.add_arc(FstArc(end, start))
    fst.initial = start
    fst.final = end
    write_fst(fst, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
