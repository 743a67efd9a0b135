"""Share of the profiled dense batch's frame rows that went through the
dense step's node kernel: 100 x the program's counter
`dense.node_pass.rows` (B a launch of `ops/dense_cuda.py`'s node pass) /
`dense.rows` (B a frame of `DenseBeamSearch._decode`), in %.  0 where
no frame went through the kernel (the plain passes); None on a program
without the counters.
Layer: dense step (`decoder/search_dense.py`).  Moves: `xrt`."""

from portbench import program_spans


def read(run):
    rows = program_spans.traced_count("dense.rows")
    if not rows:
        return None
    return 100.0 * (program_spans.traced_count("dense.node_pass.rows")
                    or 0) / rows
