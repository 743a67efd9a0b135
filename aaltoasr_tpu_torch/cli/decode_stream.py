"""decode_stream: raw audio -> streaming recognition
(`decoder/decode-stream.cc`).

Counterpart of `aaltoasr_tpu/cli/decode_stream.py`, with the same flags
and output lines: 16-bit raw audio (a file, or stdin) arrives in
half-second chunks; each new block of ``--block-frames`` frames gets its
features (``features_range`` over the running sample buffer, so the
feature DAG's context is honoured), LNA-normalized state log-probs, and
is pushed through the push-model search (Toolbox::set_one_frame + run,
the OneFrameAcoustics path).  ``--partials`` prints the finalized
hypothesis after every block, ``--partial-every K`` the partial one
(`StreamingDecoder.partial`) every K frames, both to stderr; the final
hypothesis goes to stdout.

It runs on ``--device`` (default ``cuda``; with no GPU it raises unless
``--device cpu`` is given).  On a GPU a plain diagonal GMM scores through
both kernels, the MFCC core and the state likelihoods
(``PhoneProbs(fused=True)``), one launch each per block; full-covariance
and subspace models, which the fused scorer does not take, score through
the plain scorer, as they do on the CPU.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from aaltoasr_tpu_torch.decoder.toolbox import Toolbox
from aaltoasr_tpu_torch.device import resolve_device
from aaltoasr_tpu_torch.formats.model_io import read_model
from aaltoasr_tpu_torch.models.phone_probs import PhoneProbs
from aaltoasr_tpu_torch.ops.gmm import scores_full_cov
from aaltoasr_tpu_torch.utils.profiling import device_trace


@device_trace()
def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="decode_stream")
    p.add_argument("-b", "--base", required=True, help="model base")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-l", "--lexicon", required=True)
    p.add_argument("-n", "--ngram", required=True)
    p.add_argument("-d", "--dur", default="")
    p.add_argument("--lm-scale", type=float, default=30.0)
    p.add_argument("--beam", type=float, default=280.0)
    p.add_argument("--tokens", type=int, default=1024)
    p.add_argument("--block-frames", type=int, default=32,
                   help="decode granularity in frames")
    p.add_argument("--raw-sample-rate", type=int, default=16000)
    p.add_argument("--partials", action="store_true",
                   help="print partial hypotheses per block")
    p.add_argument("--partial-every", type=int, default=0, metavar="K",
                   help="print the partial hypothesis (a traceback on the "
                        "device) every K frames")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a GPU "
                        "unless cpu is given)")
    p.add_argument("file", nargs="?",
                   help="raw audio file (default stdin)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    model = read_model(args.base)
    pp = PhoneProbs(model, args.config, device=device,
                    fused=device.type == "cuda"
                    and not scores_full_cov(model))
    fg = pp.fg
    scorer = pp.fused_scorer or pp.scorer

    t = Toolbox(args.base + ".ph", args.dur, device=device)
    t.lex_read(args.lexicon)
    t.ngram_read(args.ngram)
    t.set_global_beam(args.beam)
    t.set_token_limit(args.tokens)
    t.set_lm_scale(args.lm_scale)
    stream = t.use_one_frame_acoustics()

    src = open(args.file, "rb") if args.file else sys.stdin.buffer
    buf = np.zeros(0, dtype=np.float32)
    done_frames = 0
    last_partial = 0

    def flush_frames(upto: int):
        nonlocal done_frames, last_partial
        while done_frames < upto:
            hi = min(done_frames + args.block_frames, upto)
            feats = fg.features_range(buf, done_frames, hi)
            stream.push_frames(scorer.lna_log_probs(feats))
            done_frames = hi
            if args.partials:
                words = stream.result().words
                print(f"[{done_frames}] {' '.join(words)}", file=sys.stderr)
            elif (args.partial_every
                  and done_frames - last_partial >= args.partial_every):
                last_partial = done_frames
                words = stream.partial()
                print(f"[{done_frames}] {' '.join(words)}", file=sys.stderr)

    chunk_bytes = args.raw_sample_rate  # half a second of s16le
    while True:
        data = src.read(chunk_bytes)
        if not data:
            break
        samples = np.frombuffer(data, dtype="<i2").astype(np.float32)
        buf = np.concatenate([buf, samples])
        # frames fully determined so far: leave the feature DAG's right
        # context worth of frames pending until more audio arrives
        flush_frames(max(fg.num_frames(len(buf)) - 16, 0))
    flush_frames(fg.num_frames(len(buf)))
    if args.file:
        src.close()

    print(" ".join(stream.result().words))
    return 0


if __name__ == "__main__":
    sys.exit(main())
