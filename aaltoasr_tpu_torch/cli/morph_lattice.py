"""morph_lattice: morph lattices both ways the reference builds them.

Two modes:

* ``--morphset MORPHSET [INPUT [OUTPUT]]`` — the reference tool's
  semantics (`tools/morph_lattice/morph_lattice.cc:11-51`,
  `Latticer.cc:13-92`): segment a TEXT corpus into the lattice of all
  possible morph paths (``src tgt morph`` lines + final node id),
  byte-compatible with the reference binary
  (`tests/test_golden_morph_lattice.py`).

* ``--lm LM LATTICE`` — rewrite an SLF word lattice so every word arc
  becomes a chain of morph arcs (AM score on the first arc, LM scores
  cleared for morph-LM rescoring), optionally inserting a
  word-boundary morph between words (the rectool morph-rescoring
  preprocessing step).
"""

from __future__ import annotations

import argparse
import sys

from aaltoasr_tpu_torch.decoder.morpheus import Morpheus
from aaltoasr_tpu_torch.decoder.morphset import MorphSet, create_lattice
from aaltoasr_tpu_torch.decoder.slf import SlfLattice
from aaltoasr_tpu_torch.formats.arpa import read_arpa
from aaltoasr_tpu_torch.formats.treegram_bin import read_bin


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="morph_lattice")
    p.add_argument("-l", "--lm", help="morph LM (SLF-splitting mode)")
    p.add_argument("-m", "--morphset",
                   help="morph set file (one morph per line): segment"
                        " a text corpus into a morph lattice, the"
                        " reference morph-lattice tool's semantics")
    p.add_argument("-b", "--binary", action="store_true")
    p.add_argument("-o", "--out", help="output (default stdout)")
    p.add_argument("-w", "--word-boundary", default="<w>",
                   help="word boundary morph ('' = none)")
    p.add_argument("lattice", nargs="?",
                   help="input SLF lattice (--lm mode) or input text"
                        " file, '-' = stdin (--morphset mode)")
    args = p.parse_args(argv)

    if args.morphset:
        with open(args.morphset, encoding="latin-1") as f:
            ms = MorphSet.read(f.read())
        if args.lattice and args.lattice != "-":
            with open(args.lattice, encoding="latin-1",
                      newline="") as f:
                text = f.read()
        else:
            text = sys.stdin.read()
        if args.out:
            with open(args.out, "w", encoding="latin-1") as f:
                create_lattice(ms, text, f,
                               args.word_boundary or "<w>")
        else:
            create_lattice(ms, text, sys.stdout,
                           args.word_boundary or "<w>")
        return 0

    if not args.lm or not args.lattice:
        p.error("either --morphset or --lm + LATTICE is required")

    lm = read_bin(args.lm) if args.binary else read_arpa(args.lm)
    m = Morpheus(lm, args.word_boundary or "<w>")
    lat = SlfLattice.read(args.lattice)
    out = SlfLattice(nodes=list(lat.nodes), lm_scale=lat.lm_scale,
                     wdpenalty=lat.wdpenalty, start=lat.start,
                     end=lat.end)
    use_wb = bool(args.word_boundary) and (
        args.word_boundary in lm.word_index)

    def new_node(t):
        out.nodes.append(t)
        return len(out.nodes) - 1

    for a in lat.arcs:
        w = a["W"]
        if w == "!NULL":
            out.arcs.append(dict(a))
            continue
        try:
            morphs = m.segment(w)
        except ValueError:
            print(f"morph_lattice: can not segment {w!r}; keeping",
                  file=sys.stderr)
            out.arcs.append(dict(a))
            continue
        parts = list(morphs)
        if use_wb:
            parts.append(args.word_boundary)
        cur = a["S"]
        t = out.nodes[a["S"]] if a["S"] < len(out.nodes) else 0
        for i, piece in enumerate(parts):
            tgt = a["E"] if i == len(parts) - 1 else new_node(t)
            out.arcs.append({
                "S": cur, "E": tgt, "W": piece,
                "a": a["a"] if i == 0 else 0.0, "l": 0.0})
            cur = tgt
    if args.out:
        out.write(args.out)
    else:
        out.write(sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
