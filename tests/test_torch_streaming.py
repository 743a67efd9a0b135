"""PyTorch port, streaming: `StreamingDecoder` and the `decode_stream`
CLI against the JAX package on the same inputs (CPU).

Every case of `tests/test_streaming.py` runs through both packages'
decoders: words, `partial()` ids, the word committed at the final frame
and the record words and pointers are identical, scores within rtol 1e-5
and atol 1e-3 (as `test_torch_exact.py`).  The CLI prints the same final
line, and the same partial lines with ``--partials`` and with
``--partial-every``.
"""

import numpy as np
import pytest
import torch

from aaltoasr_tpu.cli.decode_stream import main as j_decode_stream
from aaltoasr_tpu.decoder.search import BeamSearch as JBeamSearch
from aaltoasr_tpu.decoder.search import SearchConfig as JConfig
from aaltoasr_tpu.decoder.search import StreamingDecoder as JStreaming
from aaltoasr_tpu.formats import model_io

from aaltoasr_tpu_torch import convert
from aaltoasr_tpu_torch.cli.decode_stream import main as t_decode_stream
from aaltoasr_tpu_torch.decoder.search import BeamSearch, StreamingDecoder

from tests.test_decoder import ARPA_TEXT, make_decode_task, synth_obs
from tests.test_torch_exact import assert_same

torch.set_num_threads(1)


def searches(**kw):
    """The reference's and the port's `BeamSearch` on the tiny
    monophone task, at test_streaming.py's knobs."""
    model, tree, fsa = make_decode_task()
    cfg = JConfig(**{"num_tokens": 128, "num_records": 16, "beam": 1e9,
                     "lm_scale": 1.0, **kw})
    port = BeamSearch(convert.prefix_tree(tree), convert.ngram_fsa(fsa),
                      convert.hmm_model(model), convert.search_config(cfg),
                      device="cpu")
    return JBeamSearch(tree, fsa, model, cfg), port, (model, tree)


def obs_of(task, seq, **kw):
    model, tree = task
    return np.array(synth_obs(tree, model, seq, **kw))


def test_matches_offline():
    ref, port, task = searches()
    obs = obs_of(task, ["_", "a", "b", "b", "a", "_"])
    sd, jsd = StreamingDecoder(port), JStreaming(ref)
    for t in range(obs.shape[0]):
        sd.push_frame(obs[t])
        jsd.push_frame(obs[t])
    on = sd.result()
    assert_same(jsd.result(), on)
    off = port.decode(obs)
    assert on.words == off.words
    assert on.log_prob == pytest.approx(off.log_prob, rel=1e-5)


def test_partial_results_monotone_frames():
    ref, port, task = searches()
    obs = obs_of(task, ["a", "b", "b", "a"])
    sd, jsd = StreamingDecoder(port), JStreaming(ref)
    for t in range(obs.shape[0]):
        sd.push_frame(obs[t])
        jsd.push_frame(obs[t])
        if t in (3, 7, obs.shape[0] - 1):
            assert_same(jsd.result(), sd.result())
    assert sd.frame == jsd.frame == obs.shape[0]
    assert sd.result().words == port.decode(obs).words


def test_device_partial_matches_result():
    """partial() at every probe point equals the reference's partial(),
    and equals result() on this task."""
    ref, port, task = searches()
    obs = obs_of(task, ["_", "a", "b", "b", "a", "c", "a", "_"])
    sd, jsd = StreamingDecoder(port), JStreaming(ref)
    probes = 0
    for t in range(obs.shape[0]):
        sd.push_frame(obs[t])
        jsd.push_frame(obs[t])
        if t % 5 == 4 or t == obs.shape[0] - 1:
            got = sd.partial()
            assert got == jsd.partial() == sd.result().words
            probes += bool(got)
    assert probes >= 2
    assert sd.partial() == port.decode(obs).words


def test_device_partial_interleaves_with_flush():
    """A small buffer (doubled on the way) and partials every 7 frames."""
    ref, port, task = searches()
    obs = obs_of(task, ["a", "b", "b", "a", "c", "a"])
    sd = StreamingDecoder(port, buffer_frames=8)
    jsd = JStreaming(ref, buffer_frames=8)
    for t in range(obs.shape[0]):
        sd.push_frame(obs[t])
        jsd.push_frame(obs[t])
        if t % 7 == 6:
            assert sd.partial() == jsd.partial()
    assert sd.partial() == jsd.partial() == sd.result().words
    assert_same(jsd.result(), sd.result())


def test_device_partial_chunked_push():
    ref, port, task = searches()
    obs = obs_of(task, ["b", "a", "c", "a", "b"])
    sd, jsd = StreamingDecoder(port), JStreaming(ref)
    K = 16
    for i in range(0, obs.shape[0], K):
        sd.push_frames(obs[i:i + K])
        jsd.push_frames(obs[i:i + K])
        assert sd.partial() == jsd.partial() == sd.result().words
    assert_same(jsd.result(), sd.result())


def test_reset_restarts():
    ref, port, task = searches()
    obs = obs_of(task, ["c", "a"])
    sd, jsd = StreamingDecoder(port), JStreaming(ref)
    for d in (sd, jsd):
        for t in range(obs.shape[0]):
            d.push_frame(obs[t])
    first = sd.result()
    assert_same(jsd.result(), first)
    sd.reset()
    assert sd.frame == 0
    with pytest.raises(RuntimeError, match="no frames"):
        sd.result()
    for t in range(obs.shape[0]):
        sd.push_frame(obs[t])
    assert_same(first, sd.result())


def test_push_frames_matches_per_frame():
    """Uneven blocks (1, 3, 7, the rest) across the buffer's doublings,
    a result mid-stream: the same as single pushes and as the
    reference."""
    ref, port, task = searches()
    obs = obs_of(task, ["_", "a", "b", "b", "a", "_"])
    T = obs.shape[0]
    sd = StreamingDecoder(port, buffer_frames=5)
    jsd = JStreaming(ref, buffer_frames=5)
    one = StreamingDecoder(port, buffer_frames=5)
    cuts = [0, 1, 4, 11, T]
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        sd.push_frames(obs[lo:hi])
        jsd.push_frames(obs[lo:hi])
        for t in range(lo, hi):
            one.push_frame(obs[t])
        if lo == 4:
            assert_same(jsd.result(), sd.result())
    assert sd.frame == T
    on = sd.result()
    assert_same(jsd.result(), on)
    assert_same(one.result(), on)
    assert on.words == port.decode(obs).words


def test_mixed_single_and_block_pushes():
    ref, port, task = searches()
    obs = obs_of(task, ["c", "a", "b", "b"])
    sd, jsd = StreamingDecoder(port), JStreaming(ref)
    for d in (sd, jsd):
        d.push_frame(obs[0])
        d.push_frame(obs[1])
        d.push_frames(obs[2:6])
        for t in range(6, obs.shape[0]):
            d.push_frame(obs[t])
    assert_same(jsd.result(), sd.result())


def test_buffer_spill_matches_offline():
    ref, port, task = searches()
    obs = obs_of(task, ["_", "a", "b", "b", "a", "_"])
    sd = StreamingDecoder(port, buffer_frames=5)
    jsd = JStreaming(ref, buffer_frames=5)
    for t in range(obs.shape[0]):
        sd.push_frame(obs[t])
        jsd.push_frame(obs[t])
        if t % 7 == 6:
            assert_same(jsd.result(), sd.result())
    assert_same(jsd.result(), sd.result())
    off = port.decode(obs)
    assert sd.result().words == off.words


@pytest.mark.parametrize("ring,partial_words", [(12, 64), (16384, 2)])
def test_partial_horizon(ring, partial_words):
    """partial() keeps the reference's cuts: words older than the ring
    horizon, and all but the newest ``partial_words``."""
    ref, port, task = searches()
    obs = obs_of(task, ["_", "a", "b", "c", "a", "b", "a", "_"])
    kw = dict(buffer_frames=4, ring_frames=ring,
              partial_words=partial_words)
    sd, jsd = StreamingDecoder(port, **kw), JStreaming(ref, **kw)
    full = []
    for t in range(obs.shape[0]):
        sd.push_frame(obs[t])
        jsd.push_frame(obs[t])
        got = sd.partial()
        assert got == jsd.partial(), t
        full.append(len(sd.result().words) > len(got))
    assert any(full)
    assert_same(jsd.result(), sd.result())


def test_streaming_options():
    """The stream runs every option of its search: context lookahead,
    the compaction knobs and a pruning beam that carries the
    committed-word count."""
    kw = dict(lm_lookahead=3, overflow_tokens=8, we_prewalk=32,
              reentry_prewalk=2, eq_word_count_beam=20.0,
              require_sentence_end=True, lm_scale=4.0)
    ref, port, task = searches(**kw)
    obs = obs_of(task, ["_", "a", "b", "b", "a", "c", "a", "_"], noise=1.0)
    sd, jsd = StreamingDecoder(port), JStreaming(ref)
    for lo in range(0, obs.shape[0], 5):
        sd.push_frames(obs[lo:lo + 5])
        jsd.push_frames(obs[lo:lo + 5])
        assert sd.partial() == jsd.partial()
    assert_same(jsd.result(), sd.result())
    assert_same(port.decode(obs), sd.result())


# ---- the CLI -------------------------------------------------------------

# tests/test_streaming.py's feature configuration
FEATURES = "".join(
    f"module\n{{\n  name {n}\n  type {t}\n{extra}}}\n" for n, t, extra in [
        ("audio", "audiofile", "  sample_rate 16000\n"),
        ("fft", "fft", "  sources audio\n"),
        ("mel", "mel", "  sources fft\n"),
        ("dct", "dct", "  sources mel\n  dim 4\n")])

def _cli_files(tmp_path):
    model, tree, fsa = make_decode_task()
    model_io.write_model(str(tmp_path / "m"), model)
    (tmp_path / "lm.arpa").write_text(ARPA_TEXT)
    (tmp_path / "w.lex").write_text("yksi a b\nkaksi b a\nkolme c a\n_ _\n")
    (tmp_path / "f.cfg").write_text(FEATURES)
    rng = np.random.default_rng(0)
    sig = (1200 * np.sin(2 * np.pi * 500 * np.arange(9600) / 16000)
           + 100 * rng.standard_normal(9600)).astype("<i2")
    (tmp_path / "a.raw").write_bytes(sig.tobytes())
    return ["-b", str(tmp_path / "m"), "-c", str(tmp_path / "f.cfg"),
            "-l", str(tmp_path / "w.lex"), "-n", str(tmp_path / "lm.arpa"),
            "--lm-scale", "1.0"]


@pytest.mark.parametrize("extra", [["--partials"],
                                   ["--partial-every", "16"],
                                   ["--block-frames", "7", "--tokens", "64"]])
def test_decode_stream_matches_reference(tmp_path, capsys, extra):
    """The same stdout (the final line) and the same stderr (the
    partial lines) as the reference's CLI on the same raw file."""
    base = _cli_files(tmp_path)
    raw = str(tmp_path / "a.raw")
    assert j_decode_stream(base + extra + [raw]) == 0
    ref = capsys.readouterr()
    assert t_decode_stream(base + extra + ["--device", "cpu", raw]) == 0
    got = capsys.readouterr()
    assert got.out == ref.out and ref.out.endswith("\n")
    assert got.err == ref.err
    if "--block-frames" not in extra:
        assert "[" in got.err


def test_decode_stream_needs_a_device(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = _cli_files(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_decode_stream(base + [str(tmp_path / "a.raw")])
