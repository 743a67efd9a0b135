"""hmm2fsm: expand the HMM set to a transition-indexed FSM
(`decoder/src/hmm2fsm.cc`, used by the create_hmmnets FST pipeline).

Emits one MIT-FST ASCII network where each phone is a parallel path of
transition-indexed arcs between a shared initial and final node — the
"H" component consumed by composition (hmms2trinet.pl/create_hmmnets.pl
pipeline; our transcript_hmmnet builds numerators directly, this tool
keeps the file-level interface alive for external pipelines).

Host copy of `aaltoasr_tpu/cli/hmm2fsm.py`.
"""

from __future__ import annotations

import argparse
import sys

from aaltoasr_tpu_torch.formats.fst import Fst, FstArc, write_fst
from aaltoasr_tpu_torch.formats.model_io import read_model
from aaltoasr_tpu_torch.models.hmm import TransitionTable


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="hmm2fsm")
    p.add_argument("-b", "--base", required=True, help="model base name")
    p.add_argument("-o", "--out", required=True, help="output FST")
    args = p.parse_args(argv)

    model = read_model(args.base)
    table = TransitionTable.from_model(model)
    fst = Fst()
    start = 0
    final = 1
    fst.num_nodes = 2
    next_node = [2]

    def node():
        n = next_node[0]
        next_node[0] += 1
        fst.num_nodes = max(fst.num_nodes, n + 1)
        return n

    for phone in model.phones:
        k = len(phone.states)
        snode = {0: node()}
        for i in range(1, k):
            snode[i] = node()
        fst.add_arc(FstArc(start, snode[0], label=phone.label,
                           out_label=phone.label))
        for i, s in enumerate(phone.states):
            for t in range(table.state_first[s],
                           table.state_first[s] + table.state_count[s]):
                off = int(table.offset[t])
                if i + off < k:
                    tgt = snode[i + off]
                elif i + off == k:
                    tgt = final
                else:
                    continue
                fst.add_arc(FstArc(snode[i], tgt, int(t),
                                   label=phone.label))
    fst.initial = start
    fst.final = final
    write_fst(fst, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
