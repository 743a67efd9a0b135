"""wer: word/letter error rate scorer.

The reference ecosystem scores recognizer output externally (sclite /
lab scripts); recipes print hypotheses as `words (utterance-key)`
lines (`pyrectool/rectool.py` output format, also this repo's
`recognize`).  This tool closes the loop: align hypothesis vs
reference transcripts by minimum edit distance and report
substitutions / deletions / insertions and WER (optionally LER for
morph/letter systems).

Inputs: hypothesis file in `words (key)` format (recognize output) and
a reference file either in the same format or `key words...` lines.

Host copy of `aaltoasr_tpu/cli/wer.py`.
"""

from __future__ import annotations

import argparse
import re
import sys


def parse_hyp_line(line: str):
    """`some words (key)` -> (key, [words]); None for non-matching."""
    m = re.match(r"^(.*)\(([^()]+)\)\s*$", line)
    if not m:
        return None
    return m.group(2).strip(), m.group(1).split()


def read_trn(path: str) -> dict:
    """Read `words (key)` lines (sclite trn format)."""
    out = {}
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            parsed = parse_hyp_line(line)
            if parsed is None:
                # fall back to `key words...`
                parts = line.split()
                parsed = (parts[0], parts[1:])
            out[parsed[0]] = parsed[1]
    return out


def align_counts(ref: list, hyp: list) -> tuple[int, int, int]:
    """(substitutions, deletions, insertions) of the min-edit path."""
    R, H = len(ref), len(hyp)
    # dp[j] = (cost, subs, dels, ins) for current row
    prev = [(j, 0, 0, j) for j in range(H + 1)]
    for i in range(1, R + 1):
        cur = [(i, 0, i, 0)] + [None] * H
        for j in range(1, H + 1):
            if ref[i - 1] == hyp[j - 1]:
                cand = [(prev[j - 1][0],) + prev[j - 1][1:]]
            else:
                c = prev[j - 1]
                cand = [(c[0] + 1, c[1] + 1, c[2], c[3])]
            d = prev[j]
            cand.append((d[0] + 1, d[1], d[2] + 1, d[3]))
            s = cur[j - 1]
            cand.append((s[0] + 1, s[1], s[2], s[3] + 1))
            cur[j] = min(cand)
        prev = cur
    _, subs, dels, ins = prev[H]
    return subs, dels, ins


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="wer")
    p.add_argument("-r", "--ref", required=True,
                   help="reference transcripts (trn or 'key words')")
    p.add_argument("-h-", "--hyp", dest="hyp", required=True,
                   help="hypotheses (recognize output)")
    p.add_argument("--letters", action="store_true",
                   help="score letters instead of words (LER; morph "
                        "systems join on '' and split characters)")
    p.add_argument("--utt", action="store_true",
                   help="print per-utterance scores")
    args = p.parse_args(argv)

    refs = read_trn(args.ref)
    hyps = read_trn(args.hyp)
    tot_ref = tot_s = tot_d = tot_i = 0
    missing = 0
    for key, ref_words in sorted(refs.items()):
        if key not in hyps:
            missing += 1
            continue
        hyp_words = hyps[key]
        if args.letters:
            ref_words = list("".join(ref_words))
            hyp_words = list("".join(hyp_words))
        s, d, i = align_counts(ref_words, hyp_words)
        tot_ref += len(ref_words)
        tot_s += s
        tot_d += d
        tot_i += i
        if args.utt:
            n = max(len(ref_words), 1)
            print(f"{key}: {100.0 * (s + d + i) / n:.2f}% "
                  f"(S={s} D={d} I={i} N={len(ref_words)})")
    if missing:
        print(f"WARNING: {missing} reference utterances without "
              f"hypotheses", file=sys.stderr)
    n = max(tot_ref, 1)
    unit = "LER" if args.letters else "WER"
    print(f"{unit}: {100.0 * (tot_s + tot_d + tot_i) / n:.2f}%  "
          f"(S={tot_s} D={tot_d} I={tot_i} N={tot_ref}, "
          f"{len(refs) - missing} utts)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
