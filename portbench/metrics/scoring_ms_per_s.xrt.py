"""Scoring time per second of audio: the `scoring` spans
(`FusedGmmScorer.lna_log_probs`, and in the LNA cell the quantization
and the fetch of the codes) in ms, over the audio seconds of the window.
Layer: scoring (`ops/gmm.py`, `ops/gmm_cuda.py`, `models/phone_probs.py`).
Moves: `xrt`."""


def read(run):
    if not run.spans.times.get("scoring") or run.work["audio_s"] <= 0:
        return None
    return 1e3 * run.spans.total("scoring") / run.work["audio_s"]
