"""vtln: ML warp-factor grid search per speaker -> .spkc
(`aku/vtln.cc:153-260`).

Counterpart of `aaltoasr_tpu/cli/vtln.py`, with the same flags plus
``--device`` (default ``cuda``; with no GPU it raises unless ``--device
cpu`` is given).  Each utterance evaluates the whole warp grid in one
batched pass (`train/vtln.py`).  ``-S`` is accepted and, as in the JAX
package, not read: the grid is centred on 1.0.
"""

from __future__ import annotations

import argparse
import sys

from aaltoasr_tpu_torch.cli.phone_probs import load_model
from aaltoasr_tpu_torch.device import resolve_device
from aaltoasr_tpu_torch.formats.feaconf import ModuleConfig
from aaltoasr_tpu_torch.formats.model_io import read_model
from aaltoasr_tpu_torch.formats.phn import read_phn
from aaltoasr_tpu_torch.formats.recipe import Recipe
from aaltoasr_tpu_torch.formats.spkc import SpeakerConfig
from aaltoasr_tpu_torch.frontend.audio import read_audio
from aaltoasr_tpu_torch.frontend.generator import FeatureGenerator
from aaltoasr_tpu_torch.models.hmm import TransitionTable
from aaltoasr_tpu_torch.ops.gmm import GmmScorer
from aaltoasr_tpu_torch.train.vtln import (
    VtlnEstimator, alignment_frame_states)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="vtln")
    p.add_argument("-b", "--base")
    p.add_argument("-g", "--gk"), p.add_argument("-m", "--mc")
    p.add_argument("-p", "--ph")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-r", "--recipe", required=True)
    p.add_argument("-o", "--out", required=True, help="output .spkc")
    p.add_argument("-v", "--vtln-module", default="vtln",
                   help="name of the vtln module in the config")
    p.add_argument("-O", "--ophn", action="store_true",
                   help="use output (alignment) phns: fixed-"
                        "segmentation likelihood (vtln.cc -O)")
    p.add_argument("-S", "--speakers",
                   help="prior speaker config (accepted, not read)")
    p.add_argument("--grid-size", type=int, default=21)
    p.add_argument("--grid-rad", type=float, default=0.1)
    p.add_argument("-B", "--batch", type=int, default=0)
    p.add_argument("-I", "--bindex", type=int, default=0)
    p.add_argument("-i", "--info", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a GPU "
                        "unless cpu is given)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    model = load_model(args)
    if isinstance(model, str):
        model = read_model(model)
    fg = FeatureGenerator(args.config, device=device)
    table = TransitionTable.from_model(model)
    scorer = GmmScorer.from_model(model, device=device)
    est = VtlnEstimator(model, table, scorer, fg, args.vtln_module,
                        radius=args.grid_rad, size=args.grid_size)

    recipe = Recipe.read(args.recipe, args.batch, args.bindex)
    by_speaker: dict = {}
    for rinfo in recipe:
        by_speaker.setdefault(rinfo.speaker_id, []).append(rinfo)

    spkc = SpeakerConfig()
    for speaker, infos in by_speaker.items():
        utts = []
        for rinfo in infos:
            samples, _ = read_audio(rinfo.audio_path, fg.sample_rate)
            if args.ophn:
                entries = read_phn(rinfo.alignment_path)
                spf = round(fg.sample_rate / fg.frame_rate)
                utts.append((samples, alignment_frame_states(
                    model, entries, spf)))
            else:
                labels = [e.label for e in read_phn(rinfo.transcript_path)]
                utts.append((samples, labels))
        warp, _total, _warps = est.estimate_speaker(utts, aligned=args.ophn)
        if args.info > 0:
            print(f"{speaker or '(default)'}: warp {warp:.3f}",
                  file=sys.stderr)
        cfg = ModuleConfig()
        cfg.set("warp_factor", warp)
        spkc.speakers.setdefault(speaker or "default", {})[
            ("feature", args.vtln_module)] = cfg
    spkc.save(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
