"""`estep_fb_kernel_pct` from the program's counters: None on a program
without them or without the kernel, 0 where no padded frame went
through the kernel, 100 where every one did."""

import pytest

from portbench import program_spans, run


def _with_counts(monkeypatch, counts):
    monkeypatch.setattr(program_spans, "_tracer", lambda: (
        {}, lambda name, traced=False: counts.get(name, 0)))


@pytest.mark.parametrize("counts,want", [
    ({}, None),
    ({"estep.padded_frames": 15616}, 0.0),
    ({"fb.frames": 15616}, None),
    ({"fb.frames": 15616, "estep.padded_frames": 15616}, 100.0),
    ({"fb.frames": 4096, "estep.padded_frames": 16384}, 25.0)])
def test_share_of_padded_frames(monkeypatch, counts, want):
    _with_counts(monkeypatch, counts)
    assert run.load_reader("estep_fb_kernel_pct")(None) == want


def test_none_without_the_tracer(monkeypatch):
    monkeypatch.setattr(program_spans, "_tracer", lambda: None)
    assert run.load_reader("estep_fb_kernel_pct")(None) is None


def test_none_on_a_program_without_the_kernel(monkeypatch):
    reader = run.load_reader("estep_fb_kernel_pct")
    monkeypatch.setitem(reader.__globals__, "_has_kernel", lambda: False)
    _with_counts(monkeypatch, {"fb.frames": 0,
                               "estep.padded_frames": 15616})
    assert reader(None) is None
