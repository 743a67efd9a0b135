"""The dense step's `dense.words` spans (phase 2, word ends and the LM
walk, in `DenseBeamSearch._step`) over the profiled batch, in ms per
audio second.
Layer: dense step (`decoder/search_dense.py`).  Moves: `xrt`."""

from portbench import program_spans


def read(run):
    return program_spans.ms_per_audio_s(run, ("dense.words",))
