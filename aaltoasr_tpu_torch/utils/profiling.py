"""Tracing and profiling: the program's spans and counters, and the
device trace.

Counterpart of `aaltoasr_tpu/utils/profiling.py`.  The reference's
observability is `-i INFO` stderr prints, manual stopwatches
(`decoder/src/Timer.hh`) and gprof builds (SURVEY §5.1).  Here:

* `span(name, unit=None)` — a named span of the program (``with
  span("dense.step", i): ...``).  Spans record only while a
  `torch.profiler` profile is active (`torch.autograd.profiler.
  _is_profiler_enabled`, which torch sets for any set of activities,
  a CUDA-only profile included): there is no other switch.  Off, a span
  costs one attribute check and returns a shared null context; it
  allocates nothing and never synchronizes.  On, it keeps (name, start,
  end, parent, unit) in memory, start and end from `time.time_ns()`:
  the profiler stamps its events on Unix-time nanoseconds too, so the
  records share the device trace's clock even where the profile traces
  the device alone.  Each span is also an ``asr/<name>`` range among
  the profiler's host events where the profile traces the host.  The
  range is an ordinary operator scope, not a user annotation, so it is
  not copied onto the device timeline as a user annotation would be.
  Spans are enqueue time on the host: none waits for the device, so
  device work shows in the span that waits for it (a fetch).
* `count(name, n=1)` — a plain integer counter, always on; the part
  counted while tracing is on is kept apart (`counter(name,
  traced=True)`).  Callers count at call granularity.
* `spans()`, `totals()` (per name: count, total and self ns; self time
  is a span's duration less what its child spans cover), `counter()`,
  `reset()`, `summary()`.
* `device_trace` — context manager (and decorator) around
  `torch.profiler.profile` writing a Chrome trace (``*.pt.trace.json``,
  viewable in Perfetto or TensorBoard's profiler plugin) into a
  directory (set ``AALTOASR_TRACE_DIR`` or pass a path): host
  operators, the GPU's kernels and copies when a card is present, and
  the spans recorded under it as a track of their own; then the span
  and counter summary on stderr.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import sys
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _autograd_profiler


class SpanRecord(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int          # index of the enclosing span's record, or -1
    unit: object         # the utterance, batch, frame or block, or None


class _Span:
    __slots__ = ("tracer", "name", "unit", "rec", "range")

    def __init__(self, tracer, name, unit):
        self.tracer, self.name, self.unit = tracer, name, unit

    def __enter__(self):
        tr = self.tracer
        self.range = torch._C._profiler._RecordFunctionFast(
            "asr/" + self.name)
        self.range.__enter__()
        self.rec = [self.name, time.time_ns(), 0,
                    tr._open[-1] if tr._open else -1, self.unit]
        tr._open.append(len(tr._records))
        tr._records.append(self.rec)
        return self

    def __exit__(self, *exc):
        self.rec[2] = time.time_ns()
        if self.tracer._open:
            self.tracer._open.pop()
        self.range.__exit__(*exc)
        return False


class Tracer:
    """Span records and counters of one process (the module-level
    `TRACER` is the program's)."""

    def __init__(self):
        self._records: list = []
        self._open: list = []            # indices of the open spans
        self.counts: dict = {}
        self.traced_counts: dict = {}

    def span(self, name: str, unit=None):
        if not _autograd_profiler._is_profiler_enabled:
            return _NULL
        return _Span(self, name, unit)

    def count(self, name: str, n: int = 1) -> None:
        self.counts[name] = self.counts.get(name, 0) + n
        if _autograd_profiler._is_profiler_enabled:
            self.traced_counts[name] = self.traced_counts.get(name, 0) + n

    def counter(self, name: str, traced: bool = False) -> int:
        """Counted since the last `reset`; with ``traced`` only while
        tracing was on."""
        return (self.traced_counts if traced else self.counts).get(name, 0)

    def spans(self, since: int = 0) -> list:
        """The records from index ``since`` on, in start order (an open
        span's ``end_ns`` is 0)."""
        return [SpanRecord(*r) for r in self._records[since:]]

    def totals(self, since: int = 0) -> dict:
        """{name: (count, total ns, self ns)} of the closed spans from
        record ``since`` on."""
        recs = self._records
        covered = [0] * len(recs)
        for r in recs[since:]:
            if r[2] and r[3] >= since:
                covered[r[3]] += r[2] - r[1]
        out: dict = {}
        for i in range(since, len(recs)):
            name, t0, t1 = recs[i][:3]
            if not t1:
                continue
            n, tot, own = out.get(name, (0, 0, 0))
            out[name] = (n + 1, tot + t1 - t0, own + t1 - t0 - covered[i])
        return out

    def reset(self) -> None:
        self._records.clear()
        self._open.clear()
        self.counts.clear()
        self.traced_counts.clear()

    def summary(self, since: int = 0, counts_before: dict | None = None
                ) -> str:
        """Per span name the count and the total and self ms, then the
        counters (less ``counts_before``), one line each."""
        lines = [f"  {'span':<20s} {'count':>8s} {'total ms':>12s} "
                 f"{'self ms':>12s}"]
        for name, (n, tot, own) in sorted(self.totals(since).items()):
            lines.append(f"  {name:<20s} {n:8d} {tot / 1e6:12.3f} "
                         f"{own / 1e6:12.3f}")
        before = counts_before or {}
        for name in sorted(self.counts):
            v = self.counts[name] - before.get(name, 0)
            if v:
                lines.append(f"  counter {name} {v}")
        return "\n".join(lines)


_NULL = contextlib.nullcontext()
TRACER = Tracer()
span = TRACER.span
count = TRACER.count
counter = TRACER.counter
spans = TRACER.spans
totals = TRACER.totals
reset = TRACER.reset


def add_spans_to_chrome_trace(path: str, records: list) -> None:
    """Append ``records`` (`SpanRecord`s) to the Chrome trace at
    ``path`` as a process of their own, on the trace's time base."""
    with open(path) as f:
        trace = json.load(f)
    events = trace.setdefault("traceEvents", [])
    base = int(trace.get("baseTimeNanoseconds", 0))
    pids = [e["pid"] for e in events if isinstance(e.get("pid"), int)]
    pid = max(pids, default=0) + 1
    events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                   "args": {"name": "aaltoasr_tpu_torch spans"}})
    for r in records:
        if not r.end_ns:
            continue
        events.append({"ph": "X", "cat": "asr", "name": r.name, "pid": pid,
                       "tid": 0, "ts": (r.start_ns - base) / 1e3,
                       "dur": (r.end_ns - r.start_ns) / 1e3,
                       "args": {"unit": r.unit, "parent": r.parent}})
    with open(path, "w") as f:
        json.dump(trace, f)


@contextlib.contextmanager
def device_trace(trace_dir: str | None = None):
    """Capture a profile when a trace directory is configured; as a
    decorator, around each call."""
    trace_dir = trace_dir or os.environ.get("AALTOASR_TRACE_DIR")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    since = len(TRACER._records)
    counts_before = dict(TRACER.counts)
    # acc_events: one cycle; without it torch 2.11 warns on stderr that
    # it clears events at a cycle's end
    with profile(activities=activities, acc_events=True) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    # the name tensorboard_trace_handler gives a trace
    path = os.path.join(
        trace_dir, f"{socket.gethostname()}_{os.getpid()}."
        f"{time.time_ns() // 1_000_000}.pt.trace.json")
    prof.export_chrome_trace(path)
    add_spans_to_chrome_trace(path, TRACER.spans(since))
    print(f"device trace written to {trace_dir}", file=sys.stderr)
    print(TRACER.summary(since, counts_before), file=sys.stderr)
