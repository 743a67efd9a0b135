"""The exact step's `exact.words` spans (phase 2, word ends, the LM walk,
records and re-entry, in `BeamSearch._step`) summed over a block of the
profiled slice, in ms.
Layer: exact step / streaming (`decoder/search.py`).  Moves: `block_ms_p90`."""

from portbench import program_spans


def read(run):
    ns = program_spans.span_ns(("exact.words",))
    return program_spans.per_block(run, None if ns is None else ns * 1e-6)
