"""A tiny rehearsal of each cell's driver on the CPU: set-up, window,
traced window, check and the result line, without the chip."""

import json
import sys

import pytest
import torch

from portbench import run
from portbench.tests.tiny import tiny_spec

CELLS = [w["name"] for w in run.load_json(run.ROOT / "BENCHMARK.json")[
    "workloads"]]


def rehearse(name, trace, capsys, seconds=1.0):
    rc = run.main(["--workload", name, "--seed", str(2 ** 31 + 11),
                   "--seconds", str(seconds), "--trace", str(trace)],
                  t_start=None, device=torch.device("cpu"),
                  spec=tiny_spec(name))
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    return json.loads(out.out.strip().splitlines()[-1]), out.err


@pytest.mark.parametrize("name", CELLS)
def test_untraced_run_reports_its_end_to_end_metrics(name, capsys):
    res, err = rehearse(name, 0, capsys)
    bench = run.cell_spec(name)[0]
    want = {m["name"] for m in run.cell_metrics(bench, name, "end_to_end")}
    assert set(res["metrics"]) == want and "setup_s" in want
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) >= {"unanswered"}
    lines = err.strip().splitlines()
    assert all(ln.startswith("check ") for ln in lines[-len(res["checks"]):])


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_span_metrics(name, capsys):
    res, _ = rehearse(name, 1, capsys)
    bench = run.cell_spec(name)[0]
    want = {m["name"] for m in run.cell_metrics(bench, name, "per_layer")}
    # the CPU has no device trace: only span and count metrics read
    assert set(res["metrics"]) <= want
    assert set(res["metrics"]) & want
    for m in res["metrics"]:
        assert res["metrics"][m]["value"] >= 0


@pytest.mark.parametrize("name", CELLS)
def test_jax_loaded_after_the_window_leaves_no_result(name, capsys,
                                                      monkeypatch):
    """The look for JAX comes last: a module loaded by the check still
    stops the result line."""
    import types
    loop = run.loop_class(tiny_spec(name)[2]["loop"])
    orig = loop.check

    def check(self):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return orig(self)
    monkeypatch.setattr(loop, "check", check)
    rc = run.main(["--workload", name, "--seed", "5", "--seconds", "0.5",
                   "--trace", "0"], device=torch.device("cpu"),
                  spec=tiny_spec(name))
    out = capsys.readouterr()
    assert rc != 0 and out.out.strip() == ""
    assert "jax" in out.err


def test_no_chip_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out.strip() == ""


def test_every_metric_has_a_reader_and_every_cell_its_files():
    bench = run.cell_spec(CELLS[0])[0]
    for m in bench["per_layer"]:
        assert callable(run.load_reader(m["name"]))
    for w in bench["workloads"]:
        assert (run.BENCH / "workloads" / f"{w['name']}.json").exists()
        assert callable(run.loop_class(run.load_json(
            run.BENCH / "workloads" / f"{w['name']}.json")["loop"]))
