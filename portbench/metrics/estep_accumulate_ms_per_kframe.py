"""Host accumulation of the profiled E-step shard: the program's
`estep.accumulate` spans (`device_stats_to_hmm_stats` and
`HmmStats.add` of each utterance), in ms per 1,000 valid frames.
Layer: E-step (`train/driver.py`).  Moves: `stats_fps`."""

from portbench import program_spans


def read(run):
    return program_spans.ms_per_kframe(run, ("estep.accumulate",))
