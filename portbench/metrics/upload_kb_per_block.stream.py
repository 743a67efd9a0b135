"""Samples uploaded a block: the program's counter
`frontend.upload_bytes` (the running buffer that `features_range` takes
from host memory) over the profiled slice's blocks, in KiB.
Layer: frontend + scoring per block (`frontend/generator.py`).
Moves: `block_ms_p90`."""

from portbench import program_spans


def read(run):
    n = program_spans.traced_count("frontend.upload_bytes")
    return program_spans.per_block(run, None if n is None else n / 1024.0)
