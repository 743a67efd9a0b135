"""The dense decode's host traceback over the profiled batch: the
program's `dense.traceback` spans (`traceback` and
`expand_word_boundaries` of each utterance), in ms per audio second.
Layer: dense step (`decoder/search_dense.py`).  Moves: `xrt`."""

from portbench import program_spans


def read(run):
    return program_spans.ms_per_audio_s(run, ("dense.traceback",))
