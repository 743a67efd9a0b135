"""One traced run of a cell, then the program's span records joined with
the harness's spans and the profiler's events of the same slice.

    python3 portbench/span_report.py --workload <cell> --seed <n> --seconds <s>

From the root of a checkout, on the chip.  The run is `run.py --trace 1`
itself (its result line comes first); the report then prints one JSON
object a line:

- ``totals``: per program span the count and the total and self ms;
- ``harness``: each harness span's mean over the profiled units beside
  the program span that covers the same call (``estep`` against
  ``estep.shard``, ``dense`` against ``dense.decode``, ``push`` against
  ``stream.push``);
- ``sums``: the program's stage spans summed against the call they
  divide (the dense phases, glue, fetch and traceback against
  ``dense.decode``; the exact phases against the harness's ``push``;
  the E-step's stages against the harness's ``estep``);
- ``clock``: where the profile traces the host, the offsets in us
  between each span's ``asr/`` range and the tracer's own record of it
  (range start to record start, record end to range end): median and
  p99;
- ``idle``: the device-idle time of the slice (from the first record's
  start to the last one's end, the profiler's device events merged)
  given to the innermost program span open at that moment, in ms and
  as a share;
- ``cost``: one span's cost in ns on this host (a loop of spans, and
  the same loop over the null context, ``bare``), off and on under a
  CPU + CUDA and a CUDA-only profile, and the on cost of the slice's
  spans as a share of its length.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

HARNESS = {"estep": "estep.shard", "dense": "dense.decode",
           "push": "stream.push"}
DENSE_PARTS = ("dense.arcs", "dense.words", "dense.reentry", "dense.beam",
               "dense.fetch", "dense.traceback")
EXACT_PARTS = ("exact.expand", "exact.words", "exact.prune")
ESTEP_PARTS = ("estep.read", "estep.features", "estep.compile",
               "estep.upload", "estep.batch", "estep.fetch",
               "estep.accumulate")


class _Kept:
    profiler = None
    spans = None


def _keeping(cls, slot):
    class Kept(cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            setattr(_Kept, slot, self)
    return Kept


def quantile(values, q):
    v = sorted(values)
    return v[min(len(v) - 1, int(q * len(v)))] if v else None


def idle_by_span(records, busy):
    """{innermost span name or "-": idle ns} over [first start, last
    end] of ``records``; ``busy`` the merged device intervals (ns)."""
    if not records:
        return {}
    w0 = min(r.start_ns for r in records)
    w1 = max(r.end_ns for r in records)
    pts = [(r.start_ns, 1, i) for i, r in enumerate(records)]
    pts += [(r.end_ns, 0, i) for i, r in enumerate(records)]
    pts += [(a, 3, -1) for a, _ in busy] + [(b, 2, -1) for _, b in busy]
    pts.sort()
    stack, on, prev, out = [], False, None, {}
    for t, kind, i in pts:
        if prev is not None and not on:
            a, b = max(prev, w0), min(t, w1)
            if b > a:
                name = records[stack[-1]].name if stack else "-"
                out[name] = out.get(name, 0) + b - a
        prev = t
        if kind == 1:
            stack.append(i)
        elif kind == 0:
            stack.remove(i)
        else:
            on = kind == 3
    return out


def span_cost_ns(n: int = 20000) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile
    from aaltoasr_tpu_torch.utils import profiling

    def loop(span=profiling.span):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with span("cost"):
                pass
        return (time.perf_counter_ns() - t0) / n
    # the loop and a `with` on a null context alone
    out = {"bare": loop(lambda name: profiling._NULL), "off": loop()}
    acts = {"on_cpu_cuda": [ProfilerActivity.CPU],
            "on_cuda_only": []}
    if torch.cuda.is_available():
        for v in acts.values():
            v.append(ProfilerActivity.CUDA)
    for name, a in acts.items():
        if not a:
            continue
        with profile(activities=a):
            out[name] = loop()
    profiling.reset()
    return out


def report(records, totals, harness_times, events, cost) -> list:
    from portbench.roofline import merged
    lines = [{"totals": {k: [n, tot / 1e6, own / 1e6]
                         for k, (n, tot, own) in sorted(totals.items())}}]
    # the profiled units are the window's first ones
    harness = {}
    for h, prog in HARNESS.items():
        if h in harness_times and prog in totals:
            k = totals[prog][0]
            first = harness_times[h][:k]
            harness[h] = {"harness_ms": 1e3 * statistics.mean(first),
                          "program_ms": totals[prog][1] / 1e6 / k,
                          "units": k}
    lines.append({"harness": harness})

    def tot(names, own=()):
        return sum(totals[n][1] for n in names if n in totals) + sum(
            totals[n][2] for n in own if n in totals)
    sums = {}
    if "dense.decode" in totals:
        sums["dense_parts_over_decode"] = (
            tot(DENSE_PARTS, own=("dense.step",))
            / totals["dense.decode"][1])
    if "push" in harness and "exact.expand" in totals:
        sums["exact_phases_over_push"] = tot(EXACT_PARTS) / (
            1e9 * sum(harness_times["push"][:totals["stream.push"][0]]))
    if "estep" in harness:
        sums["estep_stages_over_estep"] = tot(ESTEP_PARTS) / (
            1e9 * sum(harness_times["estep"][:totals["estep.shard"][0]]))
    lines.append({"sums": sums})

    host = {}
    for name, dtype, t0, dur in events:
        if dtype == "CPU" and name.startswith("asr/"):
            host.setdefault(name[4:], []).append((t0, t0 + dur))
    starts, ends = [], []
    for name, rng in host.items():
        recs = sorted((r.start_ns, r.end_ns) for r in records
                      if r.name == name and r.end_ns)
        if len(recs) != len(rng):
            continue
        for (r0, r1), (a, b) in zip(recs, sorted(rng)):
            starts.append((r0 - a) / 1e3)
            ends.append((b - r1) / 1e3)
    clock = {"pairs": len(starts)}
    for key, v in (("start_us", starts), ("end_us", ends)):
        if v:
            clock[key] = {"median": statistics.median(v),
                          "p99": quantile(v, 0.99),
                          "abs_median": statistics.median(map(abs, v)),
                          "abs_p99": quantile([abs(x) for x in v], 0.99)}
    lines.append({"clock": clock})

    busy = merged((t0, t0 + dur) for name, dtype, t0, dur in events
                  if dtype == "CUDA" and not name.startswith("pb:"))
    idle = idle_by_span(records, busy)
    total_idle = sum(idle.values())
    lines.append({"idle": {"total_ms": total_idle / 1e6, "by_span": {
        k: [v / 1e6, 100.0 * v / max(total_idle, 1)]
        for k, v in sorted(idle.items(), key=lambda kv: -kv[1])}}})

    n_spans = sum(n for n, _, _ in totals.values())
    length = (max(r.end_ns for r in records)
              - min(r.start_ns for r in records)) if records else 0
    key = "on_cpu_cuda" if any(d == "CPU" for _, d, _, _ in events) \
        else "on_cuda_only"
    if key in cost and length:
        cost["slice_share_pct"] = 100.0 * n_spans * cost[key] / length
        cost["slice_spans"] = n_spans
    lines.append({"cost": cost})
    return lines


def main(argv=None, device=None, spec=None) -> int:
    """``device`` and ``spec`` as `run.main` takes them (rehearsals on
    the CPU)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--trace" not in argv:
        argv += ["--trace", "1"]
    from portbench import harness, run
    run.Profiler = _keeping(run.Profiler, "profiler")
    harness.Spans = _keeping(harness.Spans, "spans")
    rc = run.main(argv, device=device, spec=spec)
    if rc != 0 or _Kept.profiler is None or _Kept.profiler.prof is None:
        return rc or 1
    from aaltoasr_tpu_torch.utils import profiling
    records = [r for r in profiling.spans() if r.end_ns]
    totals = profiling.totals()
    events = [(e.name(), str(e.device_type()).split(".")[-1],
               e.start_ns(), e.duration_ns())
              for e in _Kept.profiler.prof.profiler.kineto_results.events()]
    for line in report(records, totals, _Kept.spans.times, events,
                       span_cost_ns()):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    sys.path.insert(0, str(ROOT))
    from portbench.harness import process_start
    import portbench.run
    portbench.run.T_START = process_start()
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    sys.exit(main())
