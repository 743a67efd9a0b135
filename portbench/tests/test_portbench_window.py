"""The p90, the window, the spans and the import check."""

import statistics

import pytest
import torch

from portbench import harness


def test_p90_by_hand():
    assert harness.p90(range(1, 12)) == pytest.approx(10.0)
    assert harness.p90([5.0]) == 5.0
    v = [3.0, 1.0, 2.0, 10.0]
    assert harness.p90(v) == pytest.approx(
        statistics.quantiles(v, n=10, method="inclusive")[8])


def test_window_ends_at_the_last_completion():
    t = [0.0]
    w = harness.Window(10.0, clock=lambda: t[0])
    w.start()
    starts = 0
    while w.open():
        starts += 1
        t[0] += 4.0           # a unit takes 4 s
        w.ended()
    assert starts == 3 and w.wall_s == pytest.approx(12.0)


def test_spans_record_only_when_on():
    off = harness.Spans(False, torch.device("cpu"))
    with off("x"):
        pass
    assert off.times == {} and off.mean("x") is None
    on = harness.Spans(True, torch.device("cpu"))
    for _ in range(2):
        with on("x"):
            pass
    assert len(on.times["x"]) == 2 and on.total("x") >= 0.0


def test_forbidden_modules_are_compared_whole():
    assert harness.loaded_forbidden(
        ["aaltoasr_tpu_torch.ops", "jaxtyping", "numpy"]) == []
    assert harness.loaded_forbidden(
        ["aaltoasr_tpu.ops", "jax.numpy", "flax"]) == [
            "aaltoasr_tpu", "flax", "jax"]
