"""`dense_node_pass_pct` from the program's counters: None on a program
without them, 0 where no frame row went through the node kernel, 100
where every one did."""

import pytest

from portbench import program_spans, run


def _with_counts(monkeypatch, counts):
    monkeypatch.setattr(program_spans, "_tracer", lambda: (
        {}, lambda name, traced=False: counts.get(name, 0)))


@pytest.mark.parametrize("counts,want", [
    ({}, None),
    ({"dense.node_pass.rows": 128 * 1874}, None),
    ({"dense.rows": 128 * 1874}, 0.0),
    ({"dense.rows": 128 * 1874, "dense.node_pass.rows": 128 * 1874}, 100.0),
    ({"dense.rows": 4096, "dense.node_pass.rows": 1024}, 25.0)])
def test_share_of_frame_rows(monkeypatch, counts, want):
    _with_counts(monkeypatch, counts)
    assert run.load_reader("dense_node_pass_pct")(None) == want


def test_none_without_the_tracer(monkeypatch):
    monkeypatch.setattr(program_spans, "_tracer", lambda: None)
    assert run.load_reader("dense_node_pass_pct")(None) is None
