"""mllt: estimate a semi-tied (MLLT) transform and apply it.

Counterpart of `aaltoasr_tpu/cli/mllt.py`, with the same flags plus
``--device`` (default ``cuda``; with no GPU it raises unless ``--device
cpu`` is given).  Equivalent of `estimate --mllt` (`aku/estimate.cc:372`,
HmmSet.hh:407): accumulates full second-moment statistics over the
recipe on the device (`train/mllt.full_second_moment_stats`, merged on
the host in float64), solves the semi-tied transform, rewrites the model
into MLLT space and composes the transform into the feature config's
lin_transform module.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from aaltoasr_tpu_torch.device import ieee_float32, resolve_device
from aaltoasr_tpu_torch.formats.feaconf import FeatureConfig
from aaltoasr_tpu_torch.formats.model_io import read_model, write_model
from aaltoasr_tpu_torch.formats.phn import read_phn
from aaltoasr_tpu_torch.formats.recipe import Recipe
from aaltoasr_tpu_torch.frontend.audio import read_audio
from aaltoasr_tpu_torch.frontend.generator import FeatureGenerator
from aaltoasr_tpu_torch.models.hmm import (
    TransitionTable, build_chain, pad_chain)
from aaltoasr_tpu_torch.ops.gmm import GmmScorer
from aaltoasr_tpu_torch.train import estep
from aaltoasr_tpu_torch.train.mllt import (
    apply_mllt, compose_into_config, full_second_moment_stats, solve_mllt)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mllt")
    p.add_argument("-b", "--base", required=True, help="input model base")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-r", "--recipe", required=True)
    p.add_argument("-o", "--out", required=True, help="output model base")
    p.add_argument("-C", "--out-config", required=True,
                   help="output feature configuration")
    p.add_argument("-M", "--module", default="mllt",
                   help="lin_transform module carrying the transform")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("-i", "--info", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a GPU "
                        "unless cpu is given)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    model = read_model(args.base)
    table = TransitionTable.from_model(model)
    scorer = GmmScorer.from_model(model, device=device)
    fg = FeatureGenerator(args.config, device=device)

    Gp = scorer.score_matrix.shape[1]
    gamma = np.zeros(Gp)
    m1 = np.zeros((Gp, model.dim))
    m2 = np.zeros((Gp, model.dim, model.dim))
    recipe = Recipe.read(args.recipe)
    for rinfo in recipe:
        if args.info > 0:
            print(f"Processing file: {rinfo.audio_path}", file=sys.stderr)
        samples, _ = read_audio(rinfo.audio_path, fg.sample_rate)
        feats = fg.features(samples)
        labels = [e.label for e in read_phn(rinfo.transcript_path)]
        chain = build_chain(model, table, labels)
        graph = estep.stack_graphs([pad_chain(chain, chain.num_positions)],
                                   device)
        n = torch.full((1,), feats.shape[0], dtype=torch.int64,
                       device=device)
        with ieee_float32():
            out = full_second_moment_stats(scorer, feats[None], graph, n, Gp)
        gamma += out["gamma"][0].double().cpu().numpy()
        m1 += out["m1"][0].double().cpu().numpy()
        m2 += out["m2_full"][0].double().cpu().numpy()

    G = model.num_gaussians
    A = solve_mllt(gamma[:G], m1[:G], m2[:G], iters=args.iters)
    if args.info > 0:
        print(f"MLLT determinant: {np.linalg.det(A):.6f}", file=sys.stderr)
    write_model(args.out, apply_mllt(model, A))
    cfg = FeatureConfig.load(args.config)
    compose_into_config(cfg, A, args.module)
    cfg.save(args.out_config)
    return 0


if __name__ == "__main__":
    sys.exit(main())
