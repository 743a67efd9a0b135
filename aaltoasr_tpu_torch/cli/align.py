"""align: Viterbi forced alignment, writes state-level .phn files.

Counterpart of `aaltoasr_tpu/cli/align.py` (`aku/align.cc:171-347`),
with the same flags plus ``--device`` (default ``cuda``; with no GPU it
raises unless ``--device cpu`` is given).  Where the reference runs a
moving-window Viterbi (window 4000 frames, `align.cc:60`), this runs the
shift-compiled Viterbi (`train/estep.py`) over the whole utterance.
Output lines are ``start_sample end_sample label.state`` with the 16 kHz
sample convention (`align.cc` print_line: frame * int(16000/frame_rate)).
"""

from __future__ import annotations

import argparse
import sys

import torch

from aaltoasr_tpu_torch.cli.phone_probs import load_model
from aaltoasr_tpu_torch.device import resolve_device
from aaltoasr_tpu_torch.formats.model_io import read_model
from aaltoasr_tpu_torch.formats.phn import read_phn
from aaltoasr_tpu_torch.formats.recipe import Recipe
from aaltoasr_tpu_torch.formats.spkc import SpeakerConfig
from aaltoasr_tpu_torch.frontend.audio import read_audio
from aaltoasr_tpu_torch.frontend.generator import FeatureGenerator
from aaltoasr_tpu_torch.models.hmm import (
    TransitionTable, build_chain, pad_chain)
from aaltoasr_tpu_torch.ops.gmm import GmmScorer
from aaltoasr_tpu_torch.train import estep


def align_utterance(model, table, scorer, fg, samples, labels):
    """Returns (segments, score): segments = (start_f, end_f, label, state)."""
    feats = fg.features(samples)
    chain = build_chain(model, table, labels)
    sll = scorer.state_log_likelihoods(feats)              # [T, Sp]
    pdf = torch.as_tensor(chain.pdf, dtype=torch.int64, device=feats.device)
    obs = sll[:, pdf]
    graph = estep.stack_graphs(
        [estep.shift_compile(pad_chain(chain, chain.num_positions))],
        feats.device)
    T = obs.shape[0]
    path, score = estep.masked_viterbi_shift(
        obs[None], graph, torch.full((1,), T, device=feats.device))
    path = path[0].cpu().numpy()
    segments = []
    start = 0
    for t in range(1, len(path) + 1):
        if t == len(path) or path[t] != path[start]:
            p = int(path[start])
            segments.append((start, t, chain.labels[chain.phone_index[p]],
                             int(chain.state_in_phone[p])))
            start = t
    return segments, float(score[0])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="align")
    p.add_argument("-b", "--base", help="base filename for model files")
    p.add_argument("-g", "--gk"), p.add_argument("-m", "--mc")
    p.add_argument("-p", "--ph")
    p.add_argument("-c", "--config", required=True,
                   help="feature configuration")
    p.add_argument("-r", "--recipe", required=True, help="recipe file")
    p.add_argument("-O", "--ophn", action="store_true",
                   help="output phn format (ignored: always phn)")
    p.add_argument("-S", "--speakers", help="speaker configuration file")
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
    table = TransitionTable.from_model(model)
    scorer = GmmScorer.from_model(model, device=device)
    fg = FeatureGenerator(args.config, device=device)
    spkc = SpeakerConfig.load(args.speakers) if args.speakers else None

    recipe = Recipe.read(args.recipe, args.batch, args.bindex)
    frame_mult = int(16000 / fg.frame_rate)
    for rinfo in recipe:
        if args.info > 0:
            print(f"Processing file: {rinfo.audio_path}", file=sys.stderr)
        if spkc is not None and rinfo.speaker_id:
            fg.apply_speaker_config(spkc.speaker_params(rinfo.speaker_id))
        samples, _ = read_audio(rinfo.audio_path, fg.sample_rate)
        entries = read_phn(rinfo.transcript_path)
        labels = [e.label for e in entries]
        segments, score = align_utterance(
            model, table, scorer, fg, samples, labels)
        out_path = rinfo.alignment_path or rinfo.transcript_path + ".aligned"
        with open(out_path, "w") as f:
            for (s, e, label, state) in segments:
                f.write(f"{s * frame_mult} {e * frame_mult} "
                        f"{label}.{state}\n")
        if args.info > 0:
            print(f"  log prob {score:.3f}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
