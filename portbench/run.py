"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell's workload file
(`portbench/workloads/<cell>.json`) names its loop (`loop_class`) and
traffic, and `BENCHMARK.json` its configuration
(`portbench/configs/<config>.json`) and metrics.  Set-up makes the
inputs and the model from ``--seed``, builds the program and warms up;
the window then runs for ``--seconds``;
the outputs kept from it are checked against the plain reference once
the device peak has been read and the program freed.  ``--trace 1``
adds spans and a profiled slice and reports the per-layer metrics
(`portbench/metrics/<metric>.py`).  The last line of standard output is
the result as one JSON object.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
T_START = None          # the process's start, set when run as a script
BENCH = ROOT / "portbench"
LOOPS = {"dense": ("portbench.loops.asr", "Dense"),
         "stream": ("portbench.loops.asr", "Stream"),
         "estep": ("portbench.loops.estep", "EStep")}


def loop_class(name: str):
    """The cell class of loop ``name``: one of `LOOPS`, else the module-
    level ``CELL`` of `portbench/loops/<name>.py`."""
    if name in LOOPS:
        mod, cls = LOOPS[name]
        return getattr(importlib.import_module(mod), cls)
    cell = None
    if name.isidentifier() and (BENCH / "loops" / f"{name}.py").is_file():
        cell = getattr(importlib.import_module(f"portbench.loops.{name}"),
                       "CELL", None)
    if cell is None:
        raise SystemExit(f"unknown loop {name!r}: not one of "
                         f"{sorted(LOOPS)} and no portbench/loops/{name}.py "
                         "with a CELL")
    return cell


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(name: str) -> tuple[dict, dict, dict, dict]:
    """(BENCHMARK.json, its workload entry, the workload file, the
    configuration file) of cell ``name``."""
    bench = load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"unknown workload {name!r}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return (bench, entry, load_json(BENCH / "workloads" / f"{name}.json"),
            load_json(ROOT / conf["file"]))


def cell_metrics(bench: dict, name: str, kind: str) -> list:
    """The ``kind`` ("end_to_end" or "per_layer") metrics cell ``name``
    reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or name in m["workloads"]]


def load_reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}",
        BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Profiler:
    """`torch.profiler` over the first ``units`` units of the window of a
    traced run; `step(j)` before unit j says whether it is profiled."""

    def __init__(self, on: bool, units: int, device, host: bool = True):
        self.on, self.units, self.device = on, units, device
        self.host = host        # trace host ops too (else the device only)
        self.prof = None
        self.t0 = self.t1 = None
        self.stop_s = 0.0       # collecting the trace, from t1 on

    def step(self, j: int) -> bool:
        if self.on and j == 0 and self.prof is None:
            from torch.profiler import ProfilerActivity, profile
            from portbench.harness import sync
            sync(self.device)
            acts = [ProfilerActivity.CPU] if (
                self.host or self.device.type != "cuda") else []
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            self.t0 = time.perf_counter()
        return self.on and j < self.units

    def after(self, j: int) -> None:
        if self.prof is not None and self.t1 is None and j >= self.units:
            from portbench.harness import sync
            sync(self.device)
            self.t1 = time.perf_counter()
            self.prof.__exit__(None, None, None)
            self.stop_s = time.perf_counter() - self.t1

    def result(self):
        """The profiled slice as a `roofline.Profile`, or None."""
        if self.prof is None:
            return None
        self.after(self.units)
        from portbench.roofline import Profile, trace_events
        dev, host = trace_events(self.prof)
        return Profile(dev, host, self.t1 - self.t0)


class RunView:
    """What a per-layer reader sees: ``spans``, ``profile``, ``work``
    and the window's wall seconds ``window_s``."""

    def __init__(self, spans, profile, work, window_s):
        self.spans, self.profile = spans, profile
        self.work, self.window_s = work, window_s


def main(argv=None, t_start=None, device=None, spec=None) -> int:
    """One run.  ``device`` and ``spec`` (`cell_spec`'s four dicts) are
    for rehearsals on the CPU, which skip the look for a chip."""
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    t_start = t_start or T_START or time.perf_counter()
    bench, entry, wl, cfg = spec or cell_spec(args.workload)

    import torch
    from portbench import harness
    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < entry["chips"]):
            print(f"portbench: the cell needs {entry['chips']} CUDA "
                  f"device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda:0")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    trace = bool(args.trace)
    with tempfile.TemporaryDirectory(prefix="portbench-") as workdir:
        cell = loop_class(wl["loop"])(cfg, wl, args.seed, device, workdir)
        harness.sync(device)
        setup_s = time.perf_counter() - t_start
        print(f"portbench: set-up {setup_s:.2f} s: imports and start "
              f"{setup_s - sum(s for _, s in cell.laps.laps):.2f} s, "
              f"{cell.laps.line()}", file=sys.stderr)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)

        spans = harness.Spans(trace, device)
        profiler = Profiler(trace, wl["profile_units"], device,
                            wl.get("profile_host", True))
        window = harness.Window(args.seconds)
        window.start()
        cell.run(window, spans, profiler)
        harness.sync(device)
        info = (harness.device_info(device, entry["chips"])
                if device.type == "cuda" else
                {"platform": "cpu", "kind": "cpu", "count": 1,
                 "memory_peak_bytes": 0})
        result = {"attempted": cell.attempted, "failed": cell.failed}
        metrics = {}
        if trace:
            t0 = time.perf_counter()
            prof = profiler.result()
            print(f"portbench: trace collected in {profiler.stop_s:.1f} s, "
                  f"read in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
            # the window's wall s without the trace collection in it
            busy_stop = (min(window.t_end, profiler.t1 + profiler.stop_s)
                         - profiler.t1 if profiler.t1 is not None else 0.0)
            view = RunView(spans, prof, cell.work,
                           window.wall_s - max(busy_stop, 0.0))
            for m in cell_metrics(bench, args.workload, "per_layer"):
                v = load_reader(m["name"])(view)
                if v is not None:
                    metrics[m["name"]] = harness.metric(v, m["unit"])
            if prof is not None:
                info["busy_s"] = prof.busy_s()
                info["window_s"] = prof.window_s
                result["breakdown"] = {"device_ops": prof.top_ops(),
                                       "idle_gaps": prof.idle_gaps()}
        else:
            e2e = cell.end_to_end(window)
            e2e["setup_s"] = setup_s
            for m in cell_metrics(bench, args.workload, "end_to_end"):
                metrics[m["name"]] = harness.metric(e2e[m["name"]],
                                                    m["unit"])
        cell.release()
        limits = wl["limits"]
        checks = [("unanswered", float(cell.failed), 0.0)]
        for n, v in cell.check():
            if n in limits:
                checks.append((n, v, limits[n]))
            else:
                print(f"reading {n}: {v!r} (not compared)", file=sys.stderr)
    correct = all(v <= lim for _, v, lim in checks)
    found = harness.loaded_forbidden()
    if found:
        print(f"portbench: loaded {', '.join(found)}: the run must not "
              "load JAX or the JAX package", file=sys.stderr)
        return 3
    harness.emit({"correct": correct, **result, "metrics": metrics,
                  "device": info}, checks)
    return 0


if __name__ == "__main__":
    # one process with few threads: host-bound cells spread less
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    sys.path.insert(0, str(ROOT))
    from portbench.harness import process_start
    T_START = process_start()
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
