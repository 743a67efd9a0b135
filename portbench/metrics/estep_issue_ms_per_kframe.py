"""Issue of the profiled E-step shard's device batches: the program's
`estep.batch` spans (`estep.chain_stats`, the frame loops enqueued), in
ms per 1,000 valid frames.
Layer: E-step (`train/driver.py`, `train/estep.py`).  Moves: `stats_fps`."""

from portbench import program_spans


def read(run):
    return program_spans.ms_per_kframe(run, ("estep.batch",))
