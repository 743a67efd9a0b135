"""Padding of the profiled E-step shard's device batches: 100 x (1 -
valid frames / B x T_pad), from the program's counters `estep.frames`
and `estep.padded_frames`, in %.
Layer: E-step (`train/driver.py`).  Moves: `stats_fps`."""

from portbench import program_spans


def read(run):
    frames = program_spans.traced_count("estep.frames")
    padded = program_spans.traced_count("estep.padded_frames")
    if frames is None or not padded:
        return None
    return 100.0 * (1.0 - frames / padded)
