"""The dense step's `dense.beam` spans (phase 4, observations and the
global beam, in `DenseBeamSearch._step`) over the profiled batch, in ms
per audio second.
Layer: dense step (`decoder/search_dense.py`).  Moves: `xrt`."""

from portbench import program_spans


def read(run):
    return program_spans.ms_per_audio_s(run, ("dense.beam",))
