"""The host waiting for the dense decode's finals and records over the
profiled batch: the program's `dense.fetch` spans, in ms per audio
second.
Layer: dense step (`decoder/search_dense.py`).  Moves: `xrt`."""

from portbench import program_spans


def read(run):
    return program_spans.ms_per_audio_s(run, ("dense.fetch",))
