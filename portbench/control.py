"""The control of each cell's correctness check, and the program's own
readings beside it.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --seconds <s>

For each seed the cell is set up as `run.py` sets it up and runs a
short untraced window at its own load; then the numbers that decide
`correct` are read twice on the same kept outputs: the program's, and
the control's, the plain reference computed in float32 with TF32
products (the nearest precision below the configurations' IEEE
float32) in the program's place.  Where a cell decodes, its words are
also read with a fault planted where they are produced: each
utterance's first word altered (``fault_words``).  One JSON line per
seed; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(name: str, seed: int, seconds: float, device, spec=None) -> dict:
    """{"program": [(number, value)], "control": [(number, value)]} of one
    seed."""
    import torch

    from portbench import harness, run
    bench, entry, wl, cfg = spec or run.cell_spec(name)
    with tempfile.TemporaryDirectory(prefix="portbench-") as workdir:
        cell = run.loop_class(wl["loop"])(cfg, wl, seed, device, workdir)
        window = harness.Window(seconds)
        window.start()
        cell.run(window, harness.Spans(False, device),
                 run.Profiler(False, 0, device))
        harness.sync(device)
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            control = cell.control()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old
        cell.release()
        program = cell.check()
        out = {"program": program, "control": control}
        if getattr(cell, "hyps", None):
            out["fault_words"] = cell.words_check(
                {u: altered(w) for u, w in cell.hyps.items()})
    return out


def altered(words: list) -> list:
    """``words`` with the first replaced by another word of the task."""
    w = list(words) or ["w0"]
    w[0] = "w1" if w[0] != "w1" else "w2"
    return w


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("portbench control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = torch.cuda.get_device_name(device)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = readings(args.workload, seed, args.seconds, device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "card": card, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
