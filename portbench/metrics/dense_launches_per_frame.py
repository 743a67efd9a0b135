"""Kernel launches of the dense decode per padded batch frame: the
profiler's kernels (copies and fills apart) inside the `dense` spans of
the profiled slice, over its batches' B x T_pad frames.
Layer: dense step (`decoder/search_dense.py`).  Moves: `xrt`."""


def read(run):
    frames = run.work["profiled"]["decode_frames"]
    if run.profile is None or frames <= 0:
        return None
    n = len(run.profile.kernels(within="dense"))
    return n / frames if n else None
