"""decode: batch LNA decoding — the rectool decode stage as a CLI.

Counterpart of `aaltoasr_tpu/cli/decode.py`: composes `Toolbox` like
`pyrectool/rectool.py:516-596` get_toolbox + `decode_utterance` (:987),
decodes each recipe utterance's LNA file with the exact engine on
``--device`` (default ``cuda``; with no GPU it raises unless ``--device
cpu`` is given) and prints the 1-best hypothesis.  Defaults follow
`pyrectool/recognize-batch.sh:21-23`.  ``--lattice-grammar`` decodes
against an HTK SLF lattice in place of the n-gram.
"""

from __future__ import annotations

import argparse
import sys

from aaltoasr_tpu_torch.decoder.toolbox import Toolbox
from aaltoasr_tpu_torch.formats.recipe import Recipe


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="decode")
    p.add_argument("-p", "--ph", required=True, help="HMM definitions")
    p.add_argument("-d", "--dur", default="", help="duration file")
    p.add_argument("-l", "--lexicon", required=True)
    p.add_argument("-n", "--ngram", help="ARPA LM")
    p.add_argument("--lattice-grammar",
                   help="HTK SLF lattice used as the grammar instead of an "
                        "n-gram (htk_lattice_grammar_read)")
    p.add_argument("-r", "--recipe", required=True,
                   help="recipe with lna= fields")
    p.add_argument("--beam", type=float, default=280.0)
    p.add_argument("--tokens", type=int, default=1024,
                   help="token array width")
    p.add_argument("--lm-scale", type=float, default=30.0)
    p.add_argument("--duration-scale", type=float, default=3.0)
    p.add_argument("--insertion-penalty", type=float, default=0.0)
    p.add_argument("--lookahead", type=int, default=0, choices=[0, 1, 2, 3],
                   help="LM lookahead mode (1 = unigram, 2 = bigram, 3 = "
                        "context)")
    p.add_argument("--lookahead-ngram",
                   help="separate ARPA LM for lookahead scores")
    p.add_argument("-B", "--batch", type=int, default=0)
    p.add_argument("-I", "--bindex", type=int, default=0)
    p.add_argument("-i", "--info", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a GPU "
                        "unless cpu is given)")
    args = p.parse_args(argv)

    if not (args.ngram or args.lattice_grammar):
        p.error("one of -n/--ngram or --lattice-grammar is required")
    t = Toolbox(args.ph, args.dur, device=args.device)
    t.lex_read(args.lexicon)
    if args.lattice_grammar:
        t.htk_lattice_grammar_read(args.lattice_grammar)
    else:
        t.ngram_read(args.ngram)
    t.set_global_beam(args.beam)
    t.set_token_limit(args.tokens)
    t.set_lm_scale(args.lm_scale)
    t.set_duration_scale(args.duration_scale)
    t.set_insertion_penalty(args.insertion_penalty)
    if args.lookahead_ngram:
        t.read_lookahead_ngram(args.lookahead_ngram)
    t.set_lm_lookahead(args.lookahead)

    recipe = Recipe.read(args.recipe, args.batch, args.bindex)
    for rinfo in recipe:
        if args.info > 0:
            print(f"Decoding: {rinfo.lna_path}", file=sys.stderr)
        words, _ = t.lna_decode(rinfo.lna_path)
        key = rinfo.utterance_id or rinfo.lna_path
        print(f"{' '.join(words)} ({key})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
