"""tie: decision-tree state tying -> initial tied model (`aku/tie.cc`).

Collects context-phone statistics from state-level alignment .phn files
(which must carry state numbers, tie.cc:38-41), then ties with the rule
file and writes the model or a basebind.

Counterpart of `aaltoasr_tpu/cli/tie.py`, with the same flags plus
``--device`` for the frontend (default ``cuda``; with no GPU it raises
unless ``--device cpu`` is given).  Each utterance's features are
fetched once; the context-phone pool accumulates them on the host.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from aaltoasr_tpu_torch.device import resolve_device
from aaltoasr_tpu_torch.formats.model_io import write_model
from aaltoasr_tpu_torch.formats.phn import read_phn
from aaltoasr_tpu_torch.formats.recipe import Recipe
from aaltoasr_tpu_torch.frontend.audio import read_audio
from aaltoasr_tpu_torch.frontend.generator import FeatureGenerator
from aaltoasr_tpu_torch.train.tie import PhonePool


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tie")
    p.add_argument("-c", "--config", required=True,
                   help="feature configuration")
    p.add_argument("-r", "--recipe", required=True)
    p.add_argument("-o", "--out", help="output model base")
    p.add_argument("-b", "--basebind", help="output basebind file")
    p.add_argument("-u", "--rules", required=True,
                   help="decision tree rules file")
    p.add_argument("--count", type=float, default=100.0,
                   help="minimum occupancy count per tied state")
    p.add_argument("--sgain", type=float, default=0.0,
                   help="minimum splitting likelihood gain")
    p.add_argument("--mloss", type=float,
                   help="cluster merging with maximum loglikelihood "
                        "loss")
    p.add_argument("--context", "--mcontext", type=int, default=1,
                   dest="mcontext",
                   help="maximum number of contexts (1 = triphones, "
                        "0 = unlimited context range; tie.cc:129)")
    p.add_argument("-O", "--ophn", action="store_true",
                   help="use alignment phns (out_phn)")
    p.add_argument("-i", "--info", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a GPU "
                        "unless cpu is given)")
    args = p.parse_args(argv)

    fg = FeatureGenerator(args.config, device=resolve_device(args.device))
    pool = PhonePool(fg.dim, info=args.info)
    pool.load_rules(args.rules)
    pool.min_occupancy = args.count
    pool.min_split_gain = args.sgain

    recipe = Recipe.read(args.recipe)
    spf = 16000.0 / fg.frame_rate
    for rinfo in recipe:
        path = rinfo.alignment_path if args.ophn else rinfo.transcript_path
        path = path or rinfo.transcript_path
        if args.info > 0:
            print(f"Processing file: {rinfo.audio_path}", file=sys.stderr)
        samples, _ = read_audio(rinfo.audio_path, fg.sample_rate)
        feats = fg.features(samples).cpu().numpy()
        for e in read_phn(path):
            if e.state < 0:
                raise SystemExit("Context phone tying requires phn files "
                                 "with state numbers!")
            sf, ef = e.frame_span(spf)
            ef = min(ef, feats.shape[0])
            if ef <= sf:
                continue
            pool.get_context_phone(e.label, e.state).add(
                np.ones(ef - sf), feats[sf:ef])

    pool.tie(max_context_index=args.mcontext)
    if args.mloss is not None:
        n = pool.merge(args.mloss)
        if args.info > 0:
            import sys
            print(f"Merged {n} cluster pairs", file=sys.stderr)
    if args.basebind:
        pool.save_basebind(args.basebind,
                           max_context_index=args.mcontext)
    if args.out:
        model = pool.make_model()
        write_model(args.out, model)
    return 0


if __name__ == "__main__":
    sys.exit(main())
