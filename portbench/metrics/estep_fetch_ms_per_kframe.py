"""The host waiting for the profiled E-step shard's statistics: the
program's `estep.fetch` spans (`driver.fetch`, the `.cpu()` calls), in
ms per 1,000 valid frames.
Layer: E-step (`train/driver.py`).  Moves: `stats_fps`."""

from portbench import program_spans


def read(run):
    return program_spans.ms_per_kframe(run, ("estep.fetch",))
