"""Dense decode time per second of audio: the `dense` spans
(`DenseBeamSearch.decode_batch`, words on the host) in ms, over the
audio seconds of the window.
Layer: dense step (`decoder/search_dense.py`).  Moves: `xrt`."""


def read(run):
    if not run.spans.times.get("dense") or run.work["audio_s"] <= 0:
        return None
    return 1e3 * run.spans.total("dense") / run.work["audio_s"]
