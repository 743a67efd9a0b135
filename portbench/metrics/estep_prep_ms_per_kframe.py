"""Preparation of the profiled E-step shard: the program's `estep.read`
(WAV and .phn), `estep.features` (the frontend, padded to the time
bucket), `estep.compile` (the transcript chain) and `estep.upload`
(stacked graphs and features) spans, in ms per 1,000 valid frames.
Layer: E-step (`train/driver.py`).  Moves: `stats_fps`."""

from portbench import program_spans


def read(run):
    return program_spans.ms_per_kframe(
        run, ("estep.read", "estep.features", "estep.compile",
              "estep.upload"))
