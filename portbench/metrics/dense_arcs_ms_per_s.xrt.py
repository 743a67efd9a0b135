"""The dense step's `dense.arcs` spans (phase 1, in-arc relaxation, in
`DenseBeamSearch._step`) over the profiled batch, in ms per audio
second.
Layer: dense step (`decoder/search_dense.py`).  Moves: `xrt`."""

from portbench import program_spans


def read(run):
    return program_spans.ms_per_audio_s(run, ("dense.arcs",))
