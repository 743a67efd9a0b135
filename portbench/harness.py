"""What every cell shares: the window, spans, the profiled slice, the
percentile, the result line and the import check.

A run's window opens after set-up and warm-up.  Units of work (a batch,
an utterance, a block, a shard) start while it is open, and it ends
when the last unit started in it completes.  Spans are the harness's
own, around its calls into the program's layers; they exist only in a
traced run, where each ends in ``torch.cuda.synchronize()`` and is also
a ``record_function`` range named ``pb:<span>`` in the profiler's
trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import sys
import time

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "aaltoasr_tpu")


def process_start() -> float:
    """The process's start on the `time.perf_counter` clock (Linux:
    /proc/self/stat against CLOCK_BOOTTIME), else now."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - started
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError, AttributeError):
        return time.perf_counter()


def p90(values) -> float:
    """The 90th percentile (the inclusive method of `statistics`)."""
    values = list(values)
    if len(values) == 1:
        return float(values[0])
    return float(statistics.quantiles(values, n=10, method="inclusive")[8])


def loaded_forbidden(modules=None) -> list:
    """Top-level names in ``modules`` (default `sys.modules`) that are
    JAX or the JAX package, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


class Window:
    """Open for ``seconds`` from `start`; `ended` marks each unit's
    completion, and `wall_s` runs to the last one."""

    def __init__(self, seconds: float, clock=time.perf_counter):
        self.seconds = seconds
        self.clock = clock
        self.t0 = None
        self.t_end = None

    def start(self) -> None:
        self.t0 = self.clock()
        self.t_end = self.t0

    def open(self) -> bool:
        return self.clock() - self.t0 < self.seconds

    def ended(self) -> float:
        self.t_end = self.clock()
        return self.t_end

    @property
    def wall_s(self) -> float:
        return self.t_end - self.t0


class Laps:
    """Named laps of set-up on the host clock: `lap(name)` closes the
    lap that started at the previous one."""

    def __init__(self):
        self.t = time.perf_counter()
        self.laps: list = []

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.laps.append((name, now - self.t))
        self.t = now

    def line(self) -> str:
        return ", ".join(f"{n} {s:.2f} s" for n, s in self.laps)


class Spans:
    """Named spans of a traced run: durations in seconds, each ending in
    a device synchronize.  Off in an untraced run (no synchronize, no
    record)."""

    def __init__(self, on: bool, device):
        self.on = on
        self.device = device
        self.times: dict = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"pb:{name}"):
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.times.setdefault(name, []).append(time.perf_counter() - t0)

    def total(self, name: str) -> float:
        return sum(self.times.get(name, ()))

    def mean(self, name: str):
        v = self.times.get(name)
        return sum(v) / len(v) if v else None


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_info(device, count: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def metric(value: float, unit: str) -> dict:
    return {"value": float(value), "unit": unit}


def emit(result: dict, checks: list) -> None:
    """The checks as the last lines of standard error, then the result
    line, with the checks under its last key, on standard output."""
    for name, value, limit in checks:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    result = dict(result)
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in checks}
    print(json.dumps(result), flush=True)
