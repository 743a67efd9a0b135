"""Tracing and profiling helpers.

Counterpart of `aaltoasr_tpu/utils/profiling.py`.  The reference's
observability is `-i INFO` stderr prints, manual stopwatches
(`decoder/src/Timer.hh`) and gprof builds (SURVEY §5.1).  Here:

* `StageTimer` — named wall-clock stages with a summary line (the JAX
  package's, the same text);
* `device_trace` — context manager around `torch.profiler.profile`
  writing a Chrome trace (``*.pt.trace.json``, viewable in Perfetto or
  TensorBoard's profiler plugin) into a directory (set
  ``AALTOASR_TRACE_DIR`` or pass a path): host operators, and the GPU's
  kernels and copies when a card is present.
"""

from __future__ import annotations

import contextlib
import os
import socket
import sys
import time

import torch


class StageTimer:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.stages: list = []
        self._current = None
        self._t0 = 0.0

    def start(self, name: str) -> None:
        self.stop()
        self._current = name
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._current is not None:
            self.stages.append(
                (self._current, time.perf_counter() - self._t0))
            self._current = None

    @contextlib.contextmanager
    def stage(self, name: str):
        self.start(name)
        try:
            yield
        finally:
            self.stop()

    def report(self, out=sys.stderr) -> None:
        self.stop()
        if not self.enabled:
            return
        total = sum(t for _, t in self.stages)
        for name, t in self.stages:
            print(f"  {name:<24s} {t:8.3f}s "
                  f"({100 * t / max(total, 1e-9):5.1f}%)", file=out)
        print(f"  {'total':<24s} {total:8.3f}s", file=out)


@contextlib.contextmanager
def device_trace(trace_dir: str | None = None):
    """Capture a profile when a trace directory is configured."""
    trace_dir = trace_dir or os.environ.get("AALTOASR_TRACE_DIR")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    # acc_events: one cycle; without it torch 2.11 warns on stderr that
    # it clears events at a cycle's end
    with profile(activities=activities, acc_events=True) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    # the name tensorboard_trace_handler gives a trace
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"{socket.gethostname()}_{os.getpid()}."
        f"{time.time_ns() // 1_000_000}.pt.trace.json"))
    print(f"device trace written to {trace_dir}", file=sys.stderr)
