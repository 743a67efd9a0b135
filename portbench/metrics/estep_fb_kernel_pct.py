"""Share of the profiled E-step shard's padded frames whose forward and
backward recursions ran in the forward-backward kernel: 100 x the
program's counter `fb.frames` (B x T_pad a launch of `ops/fb_cuda.py`)
/ `estep.padded_frames`, in %.  0 where the program has the kernel but
no padded frame went through it; None on a program without the kernel
or without the counters.
Layer: E-step (`train/estep.py`).  Moves: `stats_fps`."""

import importlib.util

from portbench import program_spans


def _has_kernel() -> bool:
    try:
        return importlib.util.find_spec(
            "aaltoasr_tpu_torch.ops.fb_cuda") is not None
    except ImportError:
        return False


def read(run):
    padded = program_spans.traced_count("estep.padded_frames")
    if not padded or not _has_kernel():
        return None
    frames = program_spans.traced_count("fb.frames") or 0
    return 100.0 * frames / padded
