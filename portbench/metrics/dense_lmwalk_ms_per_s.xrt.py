"""The exact LM walk inside the dense step's word-end phase: the
program's `dense.lmwalk` spans (in `DenseBeamSearch._step`'s
`dense.words`) over the profiled batch, in ms per audio second.  None
on a program without the span.
Layer: dense step (`decoder/search_dense.py`).  Moves: `xrt`."""

from portbench import program_spans


def read(run):
    return program_spans.ms_per_audio_s(run, ("dense.lmwalk",))
