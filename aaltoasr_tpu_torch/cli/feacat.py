"""feacat: dump features for one audio file (ASCII or raw floats).

Counterpart of `aaltoasr_tpu/cli/feacat.py`, with the same flags (a
subset of the reference tool's, `aku/feacat.cc:43-120`): ``--config``,
``--raw-output``, ``--start-frame/--end-frame``,
``--speakers``/``--speaker-id``, ``--write-config``; plus ``--device``
(default ``cuda``; with no GPU it raises unless ``--device cpu`` is
given).  The ASCII output is the same text as the JAX tool's.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from aaltoasr_tpu_torch.device import resolve_device
from aaltoasr_tpu_torch.formats.feaconf import FeatureConfig
from aaltoasr_tpu_torch.formats.spkc import SpeakerConfig
from aaltoasr_tpu_torch.frontend.audio import read_audio
from aaltoasr_tpu_torch.frontend.generator import FeatureGenerator


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="feacat")
    p.add_argument("file", help="audio file (WAV or raw)")
    p.add_argument("-c", "--config", required=True,
                   help="feature configuration")
    p.add_argument("-w", "--write-config", help="write feature config here")
    p.add_argument("-R", "--raw-input", action="store_true",
                   help="raw audio input")
    p.add_argument("-r", "--raw-output", action="store_true",
                   help="raw float output")
    p.add_argument("-s", "--start-frame", type=int, default=0)
    p.add_argument("-e", "--end-frame", type=int, default=-1)
    p.add_argument("-H", "--header", action="store_true",
                   help="write dimension header to raw output")
    p.add_argument("-S", "--speakers", help="speaker configuration file")
    p.add_argument("--speaker-id", default="", help="speaker to activate")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a GPU "
                        "unless cpu is given)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = FeatureConfig.load(args.config)
    fg = FeatureGenerator(cfg, device=device)
    if args.speakers:
        sc = SpeakerConfig.load(args.speakers)
        fg.apply_speaker_config(sc.speaker_params(args.speaker_id))

    if args.raw_input:
        samples, _ = read_audio(args.file, fg.sample_rate)
    else:
        samples, rate = read_audio(args.file)
        if rate != fg.sample_rate:
            print(f"warning: audio rate {rate} != config rate "
                  f"{fg.sample_rate}", file=sys.stderr)

    feats = fg.features(samples).cpu().numpy()
    end = feats.shape[0] if args.end_frame < 0 else min(
        args.end_frame, feats.shape[0])
    feats = feats[args.start_frame:end]

    if args.write_config:
        cfg.save(args.write_config)

    if args.raw_output:
        if args.header:
            sys.stdout.buffer.write(
                np.int32(feats.shape[1]).tobytes())
        sys.stdout.buffer.write(feats.astype("<f4").tobytes())
    else:
        for row in feats:
            sys.stdout.write(
                "".join(f"{v:8.4f} " for v in row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
