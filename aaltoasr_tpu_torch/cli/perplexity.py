"""perplexity: LM perplexity of text (`decoder/src/perplexity.cc`).

Host copy of `aaltoasr_tpu/cli/perplexity.py`.
"""

from __future__ import annotations

import argparse
import math
import sys

from aaltoasr_tpu_torch.formats.arpa import read_arpa
from aaltoasr_tpu_torch.formats.treegram_bin import read_bin


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="perplexity")
    p.add_argument("-l", "--lm", required=True)
    p.add_argument("--mix", action="append", nargs=2, default=[],
                   metavar=("FILE", "COEFF"),
                   help="interpolate another LM with this coefficient "
                        "(repeatable; InterTreeGram)")
    p.add_argument("-b", "--binary", action="store_true")
    p.add_argument("text", nargs="?", help="text file (default stdin)")
    args = p.parse_args(argv)

    lm = read_bin(args.lm) if args.binary else read_arpa(args.lm)
    if args.mix:
        from aaltoasr_tpu_torch.decoder.intergram import InterTreeGram
        extra = [(read_bin(f) if f.endswith(".bin") else read_arpa(f),
                  float(c)) for f, c in args.mix]
        coeffs = [1.0 - sum(c for _, c in extra)] + [c for _, c in extra]
        lm = InterTreeGram(
            [lm] + [m for m, _ in extra], coeffs)
    f = open(args.text) if args.text else sys.stdin
    total = 0.0
    n = 0
    oov = 0
    order = lm.order
    start = lm.word_index.get("<s>")
    end = lm.word_index.get("</s>")
    for line in f:
        ctx = (start,) if start is not None else ()
        words = line.split()
        if end is not None:
            words = words + ["</s>"]
        for w in words:
            wid = lm.word_index.get(w)
            if wid is None:
                oov += 1
                ctx = ()
                continue
            lp = lm.log_prob(ctx, wid)
            total += lp
            n += 1
            ctx = (ctx + (wid,))[-(order - 1):] if order > 1 else ()
    if args.text:
        f.close()
    if n == 0:
        print("no in-vocabulary words")
        return 1
    ppl = math.exp(-total / n)
    print(f"logprob (ln): {total:.4f}  words: {n}  OOV: {oov}  "
          f"perplexity: {ppl:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
