"""Mean `push` span a block: `StreamingDecoder.push_frames` of a
block's log-probs, ending in a synchronize, in ms.
Layer: exact step / streaming (`decoder/search.py`).  Moves: `block_ms_p90`."""


def read(run):
    m = run.spans.mean("push")
    return None if m is None else 1e3 * m
