"""The share of the profiled slice with no operation running on the
device (the profiler's device events, merged), in %.
Layer: device.  Moves: `xrt`."""


def read(run):
    return None if run.profile is None else run.profile.idle_pct()
