"""playseg: audition .phn segments (tools/playseg equivalent).

Same stdin protocol as the reference (`tools/playseg/playseg.cc:57-97`):
a line with ONE field opens that audio file; a line with two or more
fields is interpreted as `start end [label...]` in time units (default
0.0000625 s, i.e. 16 kHz sample numbers — the .phn convention,
PhnReader.hh:22-26) and the segment is emitted.

The reference plays segments through SDL; this environment has no audio
device, so segments go to a sink instead: `-O FILE` appends raw s16
waveform (the reference's --output mode), `--wav DIR` writes one
numbered WAV per segment, and the default streams raw s16 to stdout
(pipe to `aplay -f S16_LE -r 16000`).

Host copy of `aaltoasr_tpu/cli/playseg.py`.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from aaltoasr_tpu_torch.frontend.audio import read_audio


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="playseg")
    p.add_argument("audiofile", nargs="?", default="",
                   help="initial audio file")
    p.add_argument("-o", "--offset", type=float, default=0.0,
                   help="offset in seconds (default: 0)")
    p.add_argument("-O", "--output", default="",
                   help="append raw s16 waveform to this file")
    p.add_argument("-r", "--rate", type=int, default=16000,
                   help="output sample rate for raw/RAW inputs")
    p.add_argument("-t", "--time-unit", type=float, default=0.0000625,
                   help="time unit (s) of input times "
                        "(default: 0.0000625 = 16 kHz samples)")
    p.add_argument("--wav", default="",
                   help="write one numbered WAV per segment into DIR")
    p.add_argument("-i", "--info", type=int, default=0)
    args = p.parse_args(argv)

    samples = None
    rate = args.rate
    nseg = 0

    def open_audio(path):
        nonlocal samples, rate
        try:
            samples, rate = read_audio(path, sample_rate=args.rate)
        except Exception as e:  # match reference: warn, keep going
            print(f"WARNING: could not open audio file {path}: {e}",
                  file=sys.stderr)
            samples = None

    def emit(seg):
        nonlocal nseg
        pcm = np.clip(np.round(seg), -32768, 32767).astype("<i2")
        if args.output:
            with open(args.output, "ab") as f:
                f.write(pcm.tobytes())
        elif args.wav:
            import wave
            os.makedirs(args.wav, exist_ok=True)
            path = os.path.join(args.wav, f"seg{nseg:04d}.wav")
            with wave.open(path, "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(rate)
                w.writeframes(pcm.tobytes())
            if args.info > 0:
                print(path, file=sys.stderr)
        else:
            sys.stdout.buffer.write(pcm.tobytes())
            sys.stdout.buffer.flush()
        nseg += 1

    if args.audiofile:
        open_audio(args.audiofile)

    for line in sys.stdin:
        fields = line.split()
        if not fields:
            continue
        if len(fields) == 1:
            open_audio(fields[0])
            continue
        try:
            start_t = float(fields[0])
            end_t = float(fields[1])
        except ValueError:
            print(f"skipping invalid line:\n{line.rstrip()}",
                  file=sys.stderr)
            continue
        if samples is None:
            print("no audio file open, skipping", file=sys.stderr)
            continue
        start = round((start_t * args.time_unit + args.offset) * rate)
        end = round((end_t * args.time_unit + args.offset) * rate)
        if end <= start:
            print("end_time less or equal to start_time, skipping",
                  file=sys.stderr)
            continue
        if start < 0 or start >= len(samples):
            print("tried to seek outside the file, skipping",
                  file=sys.stderr)
            continue
        emit(samples[start:min(end, len(samples))])
    return 0


if __name__ == "__main__":
    sys.exit(main())
