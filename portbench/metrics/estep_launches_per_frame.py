"""Kernel launches per feature frame of the E-step: the profiler's
kernels (copies and fills apart) in the profiled shard over the frames
whose statistics it accumulated.
Layer: E-step (`train/estep.py`, `train/driver.py`).  Moves: `stats_fps`."""


def read(run):
    frames = run.work["profiled"]["frames"]
    if run.profile is None or frames <= 0:
        return None
    n = len(run.profile.kernels())
    return n / frames if n else None
