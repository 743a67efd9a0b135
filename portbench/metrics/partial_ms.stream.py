"""Mean `partial` span a block: `StreamingDecoder.partial()`, words on
the host, in ms.
Layer: exact step / streaming (`decoder/search.py`).  Moves: `block_ms_p90`."""


def read(run):
    m = run.spans.mean("partial")
    return None if m is None else 1e3 * m
