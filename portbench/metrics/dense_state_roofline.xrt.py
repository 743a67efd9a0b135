"""The dense step's share of its memory roofline over the profiled
batch: the least time its frames could take, the bytes of the
program's `dense.state_bytes` counter (each frame reads and writes the
carried [B, N] state once: 2 x B x N x the bytes of a node's state) at
the chip's 3.35 TB/s, against the profiler's device time of the kernels
inside the harness's `dense` span (the whole decode, its frames and
their fetch), in %.  None on a program without the counter.
Layer: dense step (`decoder/search_dense.py`).  Moves: `xrt`."""

from portbench import program_spans, roofline


def read(run):
    nbytes = program_spans.traced_count("dense.state_bytes")
    if not nbytes or run.profile is None:
        return None
    t = sum(t1 - t0 for _, t0, t1 in run.profile.kernels(within="dense"))
    if t <= 0:
        return None
    return 100.0 * nbytes / roofline.HBM_BYTES_PER_S / t
