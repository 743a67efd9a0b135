"""make_hmmnets: generate numerator / denominator training networks
(`aku/scripts/create_hmmnets.pl` + generate_den_hmmnets.pl).

Counterpart of `aaltoasr_tpu/cli/make_hmmnets.py`, with the same flags
plus ``--device`` (default ``cuda``; with no GPU it raises unless
``--device cpu`` is given).  Numerator networks come straight from the
.phn transcripts (``transcript_hmmnet``: phones -> transition arcs with
optional silences).  Denominator networks (-d) follow the reference
pipeline (create_hmmnets.pl:469-480): each utterance is scored by
`PhoneProbs` on the device (on the GPU both kernels, the fused MFCC
core and the fused state scoring, once per utterance), decoded by the
exact engine into a word graph, posterior-pruned, expanded to HMM arcs
through the lexicon, and the numerator network is unioned in
(fst_union) so the correct path always survives; both are written as
MIT-FST to the recipe's ``hmmnet=`` / ``den-hmmnet=`` fields.
"""

from __future__ import annotations

import argparse
import os
import sys

from aaltoasr_tpu_torch.device import resolve_device
from aaltoasr_tpu_torch.formats.fst import write_fst
from aaltoasr_tpu_torch.formats.model_io import read_model
from aaltoasr_tpu_torch.formats.phn import read_phn
from aaltoasr_tpu_torch.formats.recipe import Recipe
from aaltoasr_tpu_torch.models.hmm import TransitionTable
from aaltoasr_tpu_torch.models.hmmnet import (
    transcript_hmmnet, union_fst, wordgraph_hmmnet)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="make_hmmnets")
    p.add_argument("-b", "--base", required=True, help="model base")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-r", "--recipe", required=True)
    p.add_argument("-d", "--den", action="store_true",
                   help="generate denominator networks too")
    p.add_argument("-l", "--lm", help="LM (ARPA or binary), "
                   "required with -d")
    p.add_argument("--lexicon", help="pronunciation lexicon, "
                   "required with -d")
    p.add_argument("--lm-scale", type=float, default=12.0)
    p.add_argument("--beam", type=float, default=200.0)
    p.add_argument("--tokens", type=int, default=2048)
    p.add_argument("--posterior-prune", type=float, default=0.000001,
                   help="drop lattice arcs below this posterior "
                        "(lattice-tool -posterior-prune)")
    p.add_argument("--silence", default="_",
                   help="optional-silence phone label")
    p.add_argument("--no-force", action="store_true",
                   help="skip files that already exist")
    p.add_argument("-B", "--batch", type=int, default=0)
    p.add_argument("-I", "--bindex", type=int, default=0)
    p.add_argument("-i", "--info", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a GPU "
                        "unless cpu is given)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    model = read_model(args.base)
    table = TransitionTable.from_model(model)
    recipe = Recipe.read(args.recipe, args.batch, args.bindex)

    toolbox = None
    lex_entries = None
    pp = None
    if args.den:
        if not (args.lm and args.lexicon):
            print("-d requires --lm and --lexicon", file=sys.stderr)
            return 1
        from aaltoasr_tpu_torch.decoder.lexicon import read_lexicon
        from aaltoasr_tpu_torch.decoder.toolbox import Toolbox
        from aaltoasr_tpu_torch.models.phone_probs import PhoneProbs
        from aaltoasr_tpu_torch.ops.gmm import scores_full_cov
        lex_entries = read_lexicon(args.lexicon)
        toolbox = Toolbox(args.base + ".ph", device=device)
        toolbox.lex_read(args.lexicon)
        toolbox.ngram_read(args.lm, binary=args.lm.endswith(".bin"))
        toolbox.set_global_beam(args.beam)
        toolbox.set_token_limit(args.tokens)
        toolbox.set_lm_scale(args.lm_scale)
        pp = PhoneProbs(model, args.config, device=device,
                        fused=device.type == "cuda"
                        and not scores_full_cov(model))

    for rinfo in recipe:
        if not rinfo.hmmnet_path:
            print(f"Recipe must have hmmnet= fields "
                  f"({rinfo.audio_path})", file=sys.stderr)
            return 1
        if args.info > 0:
            print(f"Processing: {rinfo.audio_path}", file=sys.stderr)
        labels = [e.label for e in read_phn(rinfo.transcript_path)]
        num = transcript_hmmnet(model, table, labels,
                                optional_silence=args.silence)
        if not (args.no_force and os.path.exists(rinfo.hmmnet_path)):
            write_fst(num, rinfo.hmmnet_path)
        if not args.den:
            continue
        if not rinfo.den_hmmnet_path:
            print(f"Recipe must have den-hmmnet= fields with -d "
                  f"({rinfo.audio_path})", file=sys.stderr)
            return 1
        if args.no_force and os.path.exists(rinfo.den_hmmnet_path):
            continue
        from aaltoasr_tpu_torch.frontend.audio import read_audio
        samples, _ = read_audio(rinfo.audio_path, pp.fg.sample_rate)
        res = toolbox.decode(pp.log_probs(samples))
        den = wordgraph_hmmnet(model, table, lex_entries, res.word_graph(),
                               posterior_prune=args.posterior_prune)
        write_fst(union_fst(den, num), rinfo.den_hmmnet_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
