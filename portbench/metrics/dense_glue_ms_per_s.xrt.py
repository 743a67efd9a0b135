"""The dense step's glue over the profiled batch: the self time of the
program's `dense.step` spans (a frame of `DenseBeamSearch._decode` less
its four phases: the observation gather, the state freeze and the
record `where`s), in ms per audio second.
Layer: dense step (`decoder/search_dense.py`).  Moves: `xrt`."""

from portbench import program_spans


def read(run):
    return program_spans.ms_per_audio_s(run, ("dense.step",), own=True)
