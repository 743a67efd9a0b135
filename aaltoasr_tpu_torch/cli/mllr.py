"""mllr: CMLLR transform estimation per speaker -> .spkc
(`aku/mllr.cc:148-350`).

Counterpart of `aaltoasr_tpu/cli/mllr.py`, with the same flags plus
``--device`` (default ``cuda``; with no GPU it raises unless ``--device
cpu`` is given).  Feature-space mode (default) writes a lin_transform
parameter block per speaker; ``--regtree-classes`` builds a regression
tree over the Gaussian pool for multi-class statistics, written as a
model-namespace block (as ``--model-transform`` is).  ``-S`` applies a
prior speaker configuration (e.g. VTLN warps) to the frontend during
estimation and carries its blocks into the output.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from aaltoasr_tpu_torch.cli.phone_probs import load_model
from aaltoasr_tpu_torch.device import resolve_device
from aaltoasr_tpu_torch.formats.feaconf import ModuleConfig
from aaltoasr_tpu_torch.formats.model_io import read_model
from aaltoasr_tpu_torch.formats.phn import read_phn
from aaltoasr_tpu_torch.formats.recipe import Recipe
from aaltoasr_tpu_torch.formats.spkc import SpeakerConfig
from aaltoasr_tpu_torch.frontend.audio import read_audio
from aaltoasr_tpu_torch.frontend.generator import FeatureGenerator
from aaltoasr_tpu_torch.models.hmm import (
    TransitionTable, build_chain, pad_chain)
from aaltoasr_tpu_torch.ops.gmm import GmmScorer
from aaltoasr_tpu_torch.train.mllr import CmllrEstimator
from aaltoasr_tpu_torch.train.regtree import (
    build_regression_tree, terminal_classes)
from aaltoasr_tpu_torch.train.vtln import alignment_frame_states


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mllr")
    p.add_argument("-b", "--base")
    p.add_argument("-g", "--gk"), p.add_argument("-m", "--mc")
    p.add_argument("-p", "--ph")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-r", "--recipe", required=True)
    p.add_argument("-o", "--out", required=True, help="output .spkc")
    p.add_argument("-M", "--module", default="mllr",
                   help="lin_transform module name for the transform")
    p.add_argument("-O", "--ophn", action="store_true",
                   help="use output (alignment) phns: fixed-"
                        "segmentation accumulation (mllr.cc -O)")
    p.add_argument("--regtree-classes", type=int, default=1,
                   help="number of regression classes (1 = global)")
    p.add_argument("--model-transform", action="store_true",
                   help="write a model-namespace transform block "
                        "(Gaussian-level CMLLR, ModelModules "
                        "ConstrainedMllr) instead of a feature-space "
                        "lin_transform; required for >1 class")
    p.add_argument("--min-frames", type=float, default=1000.0)
    p.add_argument("-S", "--input-spkc", default="",
                   help="prior speaker configuration (e.g. VTLN warps) "
                        "applied during estimation and merged into the "
                        "output (rectool.py:908 vtln+mllr chaining)")
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

    C = max(1, args.regtree_classes)
    if C > 1:
        tree = build_regression_tree(model.means, num_terminals=C)
        classes = terminal_classes(tree, model.num_gaussians)
        C = int(classes.max()) + 1
    else:
        classes = np.zeros(model.num_gaussians, dtype=np.int32)
    Gp = scorer.score_matrix.shape[1]
    classes_p = np.zeros(Gp, dtype=np.int32)
    classes_p[:model.num_gaussians] = classes

    recipe = Recipe.read(args.recipe, args.batch, args.bindex)
    by_speaker: dict = {}
    for rinfo in recipe:
        by_speaker.setdefault(rinfo.speaker_id, []).append(rinfo)

    input_spkc = (SpeakerConfig.load(args.input_spkc)
                  if args.input_spkc else None)
    spkc = SpeakerConfig()
    if input_spkc is not None:
        # carry prior per-speaker parameters into the output
        for spk, mods in input_spkc.speakers.items():
            spkc.speakers.setdefault(spk, {}).update(mods)
    for speaker, infos in by_speaker.items():
        est = CmllrEstimator(scorer, table, classes_p, C,
                             model.means, model.covars)
        if input_spkc is not None:
            try:
                fg.apply_speaker_config(
                    input_spkc.speaker_params(speaker or "default"))
            except KeyError:
                pass                    # no prior block for this speaker
        for rinfo in infos:
            samples, _ = read_audio(rinfo.audio_path, fg.sample_rate)
            feats = fg.features(samples)
            if args.ophn:
                entries = read_phn(rinfo.alignment_path)
                spf = round(fg.sample_rate / fg.frame_rate)
                est.accumulate_aligned(
                    feats, alignment_frame_states(model, entries, spf))
            else:
                labels = [e.label for e in read_phn(rinfo.transcript_path)]
                chain = build_chain(model, table, labels)
                est.accumulate(feats, pad_chain(chain, chain.num_positions),
                               feats.shape[0])
        Ws = est.transforms(min_frames=args.min_frames)
        if args.info > 0:
            print(f"{speaker or '(default)'}: {C} class(es)",
                  file=sys.stderr)
        if args.model_transform or C > 1:
            # model namespace: per-class transforms + class map
            # (ConstrainedMllr blocks; self-contained .spkc)
            cfg = ModuleConfig()
            cfg.set("classes", C)
            for c in range(C):
                cfg.set(f"matrix{c}",
                        [float(x) for x in Ws[c][:, 1:].reshape(-1)])
                cfg.set(f"bias{c}", [float(x) for x in Ws[c][:, 0]])
            cfg.set("gauss_class", [int(x) for x in classes])
            spkc.speakers.setdefault(speaker or "default", {})[
                ("model", args.module)] = cfg
        else:
            # feature-space: the global transform as lin_transform
            W = Ws[0]
            cfg = ModuleConfig()
            cfg.set("matrix", [float(x) for x in W[:, 1:].reshape(-1)])
            cfg.set("bias", [float(x) for x in W[:, 0]])
            spkc.speakers.setdefault(speaker or "default", {})[
                ("feature", args.module)] = cfg
    spkc.save(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
