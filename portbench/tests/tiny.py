"""Cells of the benchmark cut to a size that a CPU test run holds."""

from __future__ import annotations

import copy

from portbench import run


def tiny_spec(name: str, words: int = 30, utterances: int = 4) -> tuple:
    """`run.cell_spec(name)` with a ``words``-word task, ``utterances``
    utterances of 2-3 s, batches of 2 and, for the E-step, a 100-state
    model in shards of ``utterances`` utterances of 2 s, one device
    batch each."""
    bench, entry, wl, cfg = copy.deepcopy(run.cell_spec(name))
    wl["lengths"].update(count=utterances, units=1, median_s=2.5, lo_s=2.0,
                         hi_s=3.0)
    if "task" in cfg:
        cfg["task"]["num_words"] = words
    if wl["loop"] == "dense":
        wl["batch"] = 2
        wl["lengths"].update(count=2, units=utterances // 2)
    if wl["loop"] == "estep":
        # utterances of one length: one shape bucket, full device batches
        wl["lengths"].update(count=utterances, units=2, median_s=2.0,
                             hi_s=2.0)
        wl["shard"] = utterances
        wl["batch"] = utterances
        cfg["model"].update(states=100, gaussians=400)
    if "check_utterances" in wl:
        wl["check_utterances"] = 2
    return bench, entry, wl, cfg
