"""dur_est: gamma duration models from state alignments -> .dur
(`aku/dur_est.cc:142-216`).

Host copy of `aaltoasr_tpu/cli/dur_est.py`.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from aaltoasr_tpu_torch.formats.model_io import read_model, write_dur
from aaltoasr_tpu_torch.formats.phn import read_phn
from aaltoasr_tpu_torch.formats.recipe import Recipe
from aaltoasr_tpu_torch.train.durations import DurationAccumulator


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dur_est")
    p.add_argument("-b", "--base", required=True, help="model base name")
    p.add_argument("-r", "--recipe", required=True,
                   help="recipe with alignment= fields (state .phn)")
    p.add_argument("-o", "--out", required=True, help="output .dur file")
    p.add_argument("-O", "--ophn", action="store_true",
                   help="use alignment (output) phns")
    p.add_argument("--skip-states", "--skip", dest="skip_states",
                   type=int, default=0)
    p.add_argument("--min-count", "--mincount", dest="min_count",
                   type=int, default=2)
    p.add_argument("--rate", type=float, default=125.0, help="frame rate")
    p.add_argument("-B", "--batch", type=int, default=0)
    p.add_argument("-I", "--bindex", type=int, default=0)
    p.add_argument("-i", "--info", type=int, default=0)
    args = p.parse_args(argv)

    model = read_model(args.base)
    label_states = {p_.label: p_.states for p_ in model.phones}
    acc = DurationAccumulator(model.num_states)
    spf = 16000.0 / args.rate
    recipe = Recipe.read(args.recipe, args.batch, args.bindex)
    for rinfo in recipe:
        path = (rinfo.alignment_path if args.ophn
                else rinfo.transcript_path) or rinfo.alignment_path
        if args.info > 0:
            print(f"Processing file: {path}", file=sys.stderr)
        # the reference never counts a file's FIRST phn line:
        # init_utterance_segmentation pre-reads one line before the
        # next_phn_line loop starts (dur_est.cc:36,190-199)
        for e in read_phn(path)[1:]:
            if e.start < 0 or e.label not in label_states:
                continue
            states = label_states[e.label]
            state = states[e.state] if 0 <= e.state < len(states) \
                else states[0]
            sf, ef = e.frame_span(spf)
            acc.add_segment(state, ef - sf)
    durations = acc.estimate(args.skip_states, args.min_count)
    write_dur(args.out, durations)
    return 0


if __name__ == "__main__":
    sys.exit(main())
