"""The exact step's `exact.expand` spans (phase 1, the token rows and in-
word expansion, in `BeamSearch._step`) summed over a block of the
profiled slice, in ms.
Layer: exact step / streaming (`decoder/search.py`).  Moves: `block_ms_p90`."""

from portbench import program_spans


def read(run):
    ns = program_spans.span_ns(("exact.expand",))
    return program_spans.per_block(run, None if ns is None else ns * 1e-6)
