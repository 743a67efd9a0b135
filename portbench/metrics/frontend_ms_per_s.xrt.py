"""Frontend time per second of audio: the harness's `frontend` spans
(`FeatureGenerator.features_batch` / `.features`, each ending in a
synchronize) in ms, over the audio seconds of the window.
Layer: frontend (`frontend/generator.py`, `frontend/modules.py`).
Moves: `xrt`."""


def read(run):
    if not run.spans.times.get("frontend") or run.work["audio_s"] <= 0:
        return None
    return 1e3 * run.spans.total("frontend") / run.work["audio_s"]
