"""The program's own spans and counters (`aaltoasr_tpu_torch/utils/
profiling.py`) for the readers of its `program_span` metrics.

The program records spans only while a profile is active, so in a
traced run its records cover the profiled slice alone (1 batch, 12
blocks, 1 shard), and counters read the part counted under it.  A
program without the tracer, or a slice without the spans, reads None.
"""

from __future__ import annotations

FRAME_RATE = 125.0      # the configurations' frames per audio second


def _tracer():
    try:
        from aaltoasr_tpu_torch.utils import profiling
        return profiling.totals(), profiling.counter
    except (ImportError, AttributeError):
        return None


def span_ns(names, own: bool = False):
    """Summed total (or, with ``own``, self) ns of the spans ``names``;
    None where none of them was recorded."""
    tr = _tracer()
    if tr is None:
        return None
    got = [tr[0][n] for n in names if n in tr[0]]
    if not got:
        return None
    return sum(t[2] if own else t[1] for t in got)


def span_count(name: str):
    tr = _tracer()
    return None if tr is None or name not in tr[0] else tr[0][name][0]


def traced_count(name: str):
    """Counted while tracing was on; None where nothing was."""
    tr = _tracer()
    if tr is None:
        return None
    n = tr[1](name, traced=True)
    return n or None


def ms_per_kframe(run, names):
    """ms of ``names`` per 1,000 valid frames of the profiled slice."""
    ns = span_ns(names)
    frames = run.work["profiled"]["frames"]
    return None if ns is None or frames <= 0 else ns * 1e-6 / (frames / 1e3)


def ms_per_audio_s(run, names, own: bool = False):
    """ms of ``names`` per audio second of the profiled slice."""
    ns = span_ns(names, own)
    audio_s = run.work["profiled"]["frames"] / FRAME_RATE
    return None if ns is None or audio_s <= 0 else ns * 1e-6 / audio_s


def per_block(run, value):
    """``value`` over the profiled slice's blocks (`stream.push` spans)."""
    blocks = span_count("stream.push")
    return None if value is None or not blocks else value / blocks
