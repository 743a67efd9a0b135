"""Device time of the dense decode's kernels by the program span that
launched them, over one traced run of a dense cell.

    python3 tools/torch_dense_span_device.py --workload fi-morph.dense-b128 \\
        --seed <n> --seconds 51

From the root of a checkout, on the card.  The run is `portbench/run.py
--trace 1` itself (its result line comes first).  Each device event of
the profiled slice is joined to the CUDA runtime call that issued it (by
the profiler's correlation id) and given to the innermost ``asr/`` range
open on the host at that call.  Prints one JSON object a line: per
innermost span its device ms, events, and the five longest kernels
(ms, count); then the totals (busy ms, the share attributed).  In a
device-bound run the host spans' own times show where the host waited,
not where the device worked: this is the device side.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def attribute(events) -> dict:
    """``events``: (name, device type, start ns, duration ns, correlation
    id, linked correlation id) of a kineto trace -> {span: {"ms", "n",
    "kernels": {name: [ms, count]}}}; span "-" for events outside every
    ``asr/`` range, "?" for events with no runtime call."""
    launch = {}
    marks = []                  # (t, order, kind, payload)
    for name, dtype, t0, dur, corr, _link in events:
        if dtype != "CUDA" and name.startswith(("cuda", "cu")):
            launch[corr] = t0
        elif dtype != "CUDA" and name.startswith("asr/"):
            marks.append((t0, 1, "open", name[4:]))
            marks.append((t0 + dur, 0, "close", name[4:]))
    out: dict = {}
    pending = []
    for name, dtype, t0, dur, corr, link in events:
        # the ranges the profiler copies onto the device timeline are
        # annotations, not work
        if dtype != "CUDA" or name.startswith(("pb:", "asr/")):
            continue
        at = launch.get(corr, launch.get(link))
        if at is None:
            _add(out, "?", name, dur)
        else:
            pending.append((at, name, dur))
    for at, name, dur in pending:
        marks.append((at, 2, "event", (name, dur)))
    marks.sort(key=lambda m: (m[0], m[1]))
    stack: list = []
    for _, _, kind, payload in marks:
        if kind == "open":
            stack.append(payload)
        elif kind == "close":
            if payload in stack:
                del stack[len(stack) - 1 - stack[::-1].index(payload)]
        else:
            _add(out, stack[-1] if stack else "-", *payload)
    return out


def _add(out, span, name, dur):
    s = out.setdefault(span, {"ms": 0.0, "n": 0, "kernels": {}})
    s["ms"] += dur * 1e-6
    s["n"] += 1
    k = s["kernels"].setdefault(name[:90], [0.0, 0])
    k[0] += dur * 1e-6
    k[1] += 1


def main(argv=None, device=None, spec=None) -> int:
    """``device`` and ``spec`` as `run.main` takes them (rehearsals on
    the CPU)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--trace" not in argv:
        argv += ["--trace", "1"]
    from portbench import run, span_report
    run.Profiler = span_report._keeping(run.Profiler, "profiler")
    rc = run.main(argv, device=device, spec=spec)
    kept = span_report._Kept.profiler
    if rc != 0 or kept is None or kept.prof is None:
        return rc or 1
    events = [(e.name(), str(e.device_type()).split(".")[-1], e.start_ns(),
               e.duration_ns(), e.correlation_id(), e.linked_correlation_id())
              for e in kept.prof.profiler.kineto_results.events()]
    spans = attribute(events)
    busy = sum(s["ms"] for s in spans.values())
    for name, s in sorted(spans.items(), key=lambda kv: -kv[1]["ms"]):
        top = sorted(s["kernels"].items(), key=lambda kv: -kv[1][0])[:5]
        print(json.dumps({"span": name, "device_ms": round(s["ms"], 3),
                          "events": s["n"],
                          "top": [[k, round(v[0], 3), v[1]] for k, v in top]}),
              flush=True)
    print(json.dumps({"device_ms": round(busy, 3), "attributed_pct": round(
        100.0 * (busy - sum(spans.get(k, {"ms": 0.0})["ms"]
                            for k in ("-", "?"))) / busy, 3) if busy else None}),
          flush=True)
    return 0


if __name__ == "__main__":
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    sys.path.insert(0, str(ROOT))
    from portbench.harness import process_start
    import portbench.run
    portbench.run.T_START = process_start()
    sys.exit(main())
