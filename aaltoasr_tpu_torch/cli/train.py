"""train: the EM training recipe driver (`aku/scripts/train.pl`).

Counterpart of `aaltoasr_tpu/cli/train.py`, with the same flags and
train.pl's skip-if-exists resume (train.pl:253-259): every iteration
writes ``BASE_ID_<i>.{ph,gk,mc}`` and a rerun skips iterations whose .ph
already exists.  Stages:

1. a full-covariance initial model is converted to diagonal
   (train.pl:143-147, gconvert -d);
2. ``--num-iters`` EM iterations: the E-step over the recipe's
   transcript chains on ``--device`` (default ``cuda``; with no GPU it
   raises unless ``--device cpu`` is given), the ML M-step, MLLT every
   ``--mllt-frequency`` iterations from ``--mllt-start-iter`` (full
   statistics, the transform folded into the model and a new .cfg), and
   Gaussian splitting every ``--split-frequency`` iterations until
   ``--split-stop-iter`` (train.pl:86-176 defaults 22/2/18);
3. Viterbi alignment + gamma duration model estimation (``--durations``);
4. Gaussian clustering (``--num-clusters``, .gcl).

``-H`` (hmmnet= networks) belongs to the hmmnet half of training and
raises `NotImplementedError`.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from aaltoasr_tpu_torch.device import resolve_device
from aaltoasr_tpu_torch.formats.feaconf import FeatureConfig
from aaltoasr_tpu_torch.formats.model_io import (
    read_model, write_dur, write_model)
from aaltoasr_tpu_torch.formats.recipe import Recipe
from aaltoasr_tpu_torch.train.accumulators import ML_BUF
from aaltoasr_tpu_torch.train.driver import EStepDriver
from aaltoasr_tpu_torch.train.estep import later
from aaltoasr_tpu_torch.train.estimate import estimate_ml
from aaltoasr_tpu_torch.train.gcluster import cluster_gaussians, write_gcl
from aaltoasr_tpu_torch.train.mllt import (
    apply_mllt, compose_into_config, solve_mllt)
from aaltoasr_tpu_torch.train.split import split_gaussians


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="train")
    p.add_argument("-b", "--base", required=True,
                   help="initial model base (e.g. from tie)")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-r", "--recipe", required=True)
    p.add_argument("-w", "--workdir", required=True)
    p.add_argument("--id", default="model", help="BASE_ID for outputs")
    p.add_argument("--num-iters", type=int, default=22)
    p.add_argument("--split-frequency", type=int, default=2)
    p.add_argument("--split-stop-iter", type=int, default=18)
    p.add_argument("--split-target", type=int, default=-1,
                   help="target total number of Gaussians")
    p.add_argument("--split-minocc", type=float, default=225.0)
    p.add_argument("--split-maxmixgauss", type=int, default=80,
                   help="max Gaussians per mixture when splitting "
                        "(train.pl:64 SPLIT_MAX_GAUSSIANS)")
    p.add_argument("--split-alpha", type=float, default=0.3,
                   help="occupancy smoothing power for splitting "
                        "(train.pl:69 SPLIT_ALPHA)")
    p.add_argument("--minvar", type=float, default=0.1)
    p.add_argument("--mllt-start-iter", type=int, default=15,
                   help="first MLLT iteration (train.pl:81; 0 = off)")
    p.add_argument("--mllt-frequency", type=int, default=2,
                   help="EM iterations between MLLT estimations")
    p.add_argument("--mllt-module", default="mllt",
                   help="lin_transform module carrying the transform")
    p.add_argument("-H", "--hmmnet", action="store_true",
                   help="train from hmmnet= networks")
    p.add_argument("-M", "--mode", default="bw", choices=["bw", "vit"])
    p.add_argument("--device-batch", type=int, default=8,
                   help="utterances per device E-step call")
    p.add_argument("--num-clusters", type=int, default=0,
                   help="Gaussian clusters for the final model (gcluster)")
    p.add_argument("--durations", action="store_true",
                   help="estimate a duration model at the end")
    p.add_argument("--dur-mincount", type=int, default=10,
                   help="min occurrence count for a state's gamma fit "
                        "(dur_est.cc default)")
    p.add_argument("--keep-sil-durations", action="store_true",
                   help="keep duration models for silence states "
                        "(train.pl:98 REMOVE_DUR_MODELS zeroes them "
                        "by default)")
    p.add_argument("-B", "--batch", type=int, default=0)
    p.add_argument("-I", "--bindex", type=int, default=0)
    p.add_argument("-i", "--info", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a GPU "
                        "unless cpu is given)")
    args = p.parse_args(argv)

    if args.hmmnet:
        raise later("training on hmmnet= networks (-H)")
    device = resolve_device(args.device)
    os.makedirs(args.workdir, exist_ok=True)
    recipe = Recipe.read(args.recipe, args.batch, args.bindex)

    model_base = args.base
    cfg_path = args.config

    # full-covariance initial models (decision-tree tying estimates
    # full) get converted to diagonal first (train.pl:143-147,222-229
    # convert_full_to_diagonal / gconvert -d)
    init_model = read_model(model_base)
    if init_model.cov_type != "diagonal_cov" or init_model.full_covars:
        conv_base = os.path.join(args.workdir, f"{args.id}_0")
        if not os.path.exists(conv_base + ".ph"):
            init_model.cov_type = "diagonal_cov"
            init_model.full_covars = {}
            init_model.gauss_kind = ["diag"] * init_model.num_gaussians
            write_model(conv_base, init_model)
            if args.info > 0:
                print("Converted initial model to diagonal covariances",
                      file=sys.stderr)
        model_base = conv_base

    # MLLT needs a lin_transform module to fold the transform into
    mllt_start = args.mllt_start_iter
    if mllt_start > 0:
        probe = FeatureConfig.load(cfg_path)
        if args.mllt_module not in probe.by_name:
            if args.info > 0:
                print(f"Config has no '{args.mllt_module}' module; "
                      "disabling MLLT iterations", file=sys.stderr)
            mllt_start = 0

    summary_path = os.path.join(args.workdir, f"{args.id}.summary")
    for it in range(1, args.num_iters + 1):
        out_base = os.path.join(args.workdir, f"{args.id}_{it}")
        if os.path.exists(out_base + ".ph"):
            if args.info > 0:
                print(f"Iteration {it} exists, skipping", file=sys.stderr)
            model_base = out_base
            if os.path.exists(out_base + ".cfg"):
                cfg_path = out_base + ".cfg"
            continue
        mllt_flag = (mllt_start > 0 and it >= mllt_start
                     and (it - mllt_start) % max(args.mllt_frequency,
                                                 1) == 0)
        model = read_model(model_base)
        driver = EStepDriver(model, cfg_path, mode=args.mode,
                             full_stats=mllt_flag, device=device)
        if mllt_flag:
            stats = driver.run_recipe(recipe, info=max(0, args.info - 1))
        else:
            stats = driver.run_recipe_batched(
                recipe, batch_size=args.device_batch,
                info=max(0, args.info - 1))
        new_model = estimate_ml(model, driver.table, stats,
                                minvar=args.minvar)
        if mllt_flag:
            # estimate --mllt inside the loop (train.pl:267-272,
            # estimate.cc:372): solve the semi-tied transform from the
            # full second moments, rewrite the model and the config
            buf = stats.buffers[ML_BUF]
            G = new_model.num_gaussians
            A = solve_mllt(buf.gamma[:G], buf.mean_acc[:G],
                           buf.ensure_full()[:G], iters=10)
            new_model = apply_mllt(new_model, A)
            cfg = FeatureConfig.load(cfg_path)
            compose_into_config(cfg, A, args.mllt_module)
            cfg.save(out_base + ".cfg")
            cfg_path = out_base + ".cfg"
            if args.info > 0:
                print(f"Iteration {it}: MLLT det "
                      f"{float(np.linalg.det(A)):.6f}", file=sys.stderr)
        did_split = 0
        if (args.split_frequency > 0 and it % args.split_frequency == 0
                and it <= args.split_stop_iter):
            new_model, did_split = split_gaussians(
                new_model, stats, minocc=args.split_minocc,
                maxg=args.split_maxmixgauss,
                numgauss=args.split_target,
                splitalpha=args.split_alpha)
        write_model(out_base, new_model)
        with open(summary_path, "a") as f:
            f.write(f"iter {it} loglikelihood {stats.num_ll:.6g} "
                    f"frames {stats.num_frames} "
                    f"gaussians {new_model.num_gaussians}\n")
        if args.info > 0:
            print(f"Iteration {it}: LL {stats.num_ll:.1f}, "
                  f"{new_model.num_gaussians} Gaussians"
                  + (f" (+{did_split} splits)" if did_split else ""),
                  file=sys.stderr)
        model_base = out_base

    final = read_model(model_base)

    if args.durations:
        dur_path = model_base + ".dur"
        if not os.path.exists(dur_path):
            from aaltoasr_tpu_torch.cli.align import align_utterance
            from aaltoasr_tpu_torch.formats.phn import read_phn
            from aaltoasr_tpu_torch.frontend.audio import read_audio
            from aaltoasr_tpu_torch.frontend.generator import (
                FeatureGenerator)
            from aaltoasr_tpu_torch.models.hmm import TransitionTable
            from aaltoasr_tpu_torch.ops.gmm import GmmScorer
            from aaltoasr_tpu_torch.train.durations import (
                DurationAccumulator)
            table = TransitionTable.from_model(final)
            scorer = GmmScorer.from_model(final, device=device)
            fg = FeatureGenerator(cfg_path, device=device)
            acc = DurationAccumulator(final.num_states)
            for rinfo in recipe:
                samples, _ = read_audio(rinfo.audio_path, fg.sample_rate)
                labels = [e.label for e in
                          read_phn(rinfo.transcript_path)]
                segments, _ = align_utterance(
                    final, table, scorer, fg, samples, labels)
                # the reference recipe's dur_est never counts a file's
                # first segment (init_utterance_segmentation pre-reads
                # one line, dur_est.cc:36,190-199); keep .dur files
                # recipe-identical
                for (s, e, label, state) in segments[1:]:
                    sts = final.phone(label).states
                    acc.add_segment(sts[state], e - s)
            durations = acc.estimate(min_count=args.dur_mincount)
            if not args.keep_sil_durations:
                # train.pl:614-623 REMOVE_DUR_MODELS: zero the gamma
                # models of silence-phone states
                for ph in final.phones:
                    if "_" in ph.label:
                        for st in ph.states:
                            durations[st] = 0.0
            write_dur(dur_path, durations)
            if args.info > 0:
                print(f"Duration model written to {dur_path}",
                      file=sys.stderr)

    if args.num_clusters > 0:
        gcl_path = model_base + ".gcl"
        if not os.path.exists(gcl_path):
            assign = cluster_gaussians(final.means, args.num_clusters)
            write_gcl(gcl_path, assign,
                      min(args.num_clusters, final.num_gaussians))

    print(model_base)
    return 0


if __name__ == "__main__":
    sys.exit(main())
