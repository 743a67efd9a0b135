"""segfea: dump features grouped per tied state (`aku/segfea.cc`).

Used for model initialization: with a basebind and alignments, features
of each tied state stream to per-state files that an initializer
consumes.  Two segmentation modes, as in the reference
(`segfea.cc:267-316`):

* ``--stateseg``: the .phn carries explicit ``label.state`` tokens; the
  segment's frames all go to that tied state.
* phone-level (default): each phone segment is divided evenly between
  the phone's states (``beg = s_beg + p*dur/pnum``).

``--occ FILE`` writes per-state SEGMENT occurrence counts
(`segfea.cc:329,448-460`: one count per contiguous block, not per
frame).

Counterpart of `aaltoasr_tpu/cli/segfea.py`, with the same flags plus
``--device`` for the frontend (default ``cuda``; with no GPU it raises
unless ``--device cpu`` is given).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from aaltoasr_tpu_torch.device import resolve_device
from aaltoasr_tpu_torch.formats.phn import read_phn
from aaltoasr_tpu_torch.formats.recipe import Recipe
from aaltoasr_tpu_torch.frontend.audio import read_audio
from aaltoasr_tpu_torch.frontend.generator import FeatureGenerator


def read_basebind(path) -> dict:
    """LABEL NUM_STATES IDX... -> {label: [state ids]}
    (fileformats.html Basebind)."""
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 3:
                continue
            n = int(parts[1])
            out[parts[0]] = [int(x) for x in parts[2:2 + n]]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="segfea")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-r", "--recipe", required=True)
    p.add_argument("-B", "--basebind", required=True)
    p.add_argument("-o", "--out-dir", required=True,
                   help="directory for per-state feature dumps")
    p.add_argument("-O", "--ophn", action="store_true",
                   help="use alignment phns")
    p.add_argument("-s", "--stateseg", action="store_true",
                   help="the segmentation is based on states")
    p.add_argument("--occ", default="",
                   help="save state occurrence (segment) counts to file")
    p.add_argument("-i", "--info", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a GPU "
                        "unless cpu is given)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)

    fg = FeatureGenerator(args.config, device=device)
    basebind = read_basebind(args.basebind)
    num_states = 1 + max((s for v in basebind.values() for s in v),
                         default=-1)
    occurrences = np.zeros(num_states, dtype=np.int64)
    os.makedirs(args.out_dir, exist_ok=True)
    spf = 16000.0 / fg.frame_rate
    files = {}

    def emit(state, block):
        # occurrence counted even for an eof-truncated empty block
        # (segfea.cc:329 increments before the frame loop)
        occurrences[state] += 1
        if block.shape[0] == 0:
            return
        if state not in files:
            files[state] = open(
                os.path.join(args.out_dir, f"state_{state}.fea"), "ab")
        files[state].write(block.astype("<f4").tobytes())

    recipe = Recipe.read(args.recipe)
    for rinfo in recipe:
        path = rinfo.alignment_path if args.ophn else rinfo.transcript_path
        if args.info > 0:
            print(f"Processing file: {rinfo.audio_path}", file=sys.stderr)
        samples, _ = read_audio(rinfo.audio_path, fg.sample_rate)
        feats = fg.features(samples).cpu().numpy()
        T = feats.shape[0]
        eof_hit = False
        for e in read_phn(path):
            if eof_hit:
                break
            if e.start < 0 or e.label not in basebind:
                continue
            states = basebind[e.label]
            # UNCLAMPED span: the even division runs on the raw
            # duration; eof truncates mid-block and abandons the rest
            # of the file (segfea.cc:331-347 goto CLOSE_FILES_AND_EXIT)
            sf, ef = e.frame_span(spf)
            if ef <= sf:
                continue
            if args.stateseg:
                state = states[e.state] if 0 <= e.state < len(states) \
                    else states[0]
                parts = [(state, sf, ef)]
            else:
                # divide the phone segment evenly between its states
                # (segfea.cc:313-316 integer arithmetic)
                dur = ef - sf
                pnum = len(states)
                parts = [(states[pi], sf + pi * dur // pnum,
                          sf + (pi + 1) * dur // pnum)
                         for pi in range(pnum)]
            for state, beg, end in parts:
                if beg >= end:
                    continue
                emit(state, feats[beg:min(end, T)])
                if end > T:
                    eof_hit = True
                    break
    for f in files.values():
        f.close()
    if args.occ:
        with open(args.occ, "w") as f:
            for i in range(num_states):
                f.write(f"{i} {int(occurrences[i])}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
