"""PyTorch port, the program's tracer (`utils/profiling.py`): spans off
outside a profile, on under one (nesting, parents, self time, the
profiler's clock), counters and `reset`, and the spans and counters of
the instrumented layers (the E-step driver, the frontend's buffer
upload, both decode steps) on tiny inputs (CPU)."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from aaltoasr_tpu_torch import convert
from aaltoasr_tpu_torch.decoder.search import BeamSearch, StreamingDecoder
from aaltoasr_tpu_torch.decoder.search_dense import DenseBeamSearch
from aaltoasr_tpu_torch.formats.feaconf import FeatureConfig
from aaltoasr_tpu_torch.formats.recipe import Recipe
from aaltoasr_tpu_torch.frontend.generator import FeatureGenerator
from aaltoasr_tpu_torch.synth import MFCC_CFG
from aaltoasr_tpu_torch.train.driver import EStepDriver
from aaltoasr_tpu_torch.utils import profiling

from tests.test_decoder import make_decode_task, synth_obs


@pytest.fixture(autouse=True)
def fresh_tracer():
    profiling.reset()
    yield
    profiling.reset()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def by_name(name):
    return [r for r in profiling.spans() if r.name == name]


def test_off_outside_a_profile():
    """No profile: every span is the one shared null context and records
    nothing; counters count, the traced part stays 0."""
    a = profiling.span("x")
    b = profiling.span("y", 3)
    assert a is b is profiling._NULL
    with a:
        with b:
            pass
    profiling.count("n", 2)
    assert profiling.spans() == [] and profiling.totals() == {}
    assert profiling.counter("n") == 2
    assert profiling.counter("n", traced=True) == 0


def test_on_under_a_profile_nesting_parents_and_self_time():
    with cpu_profile():
        with profiling.span("outer", 0):
            with profiling.span("a", 1):
                with profiling.span("c"):
                    torch.ones(8).sum()
            with profiling.span("b", 2):
                torch.ones(8).sum()
    assert profiling.span("after") is profiling._NULL
    recs = profiling.spans()
    assert [r.name for r in recs] == ["outer", "a", "c", "b"]
    assert [r.parent for r in recs] == [-1, 0, 1, 0]
    assert [r.unit for r in recs] == [0, 1, None, 2]
    for r in recs:
        assert r.start_ns <= r.end_ns
        if r.parent >= 0:
            p = recs[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    dur = {r.name: r.end_ns - r.start_ns for r in recs}
    tot = profiling.totals()
    assert tot["outer"] == (1, dur["outer"],
                            dur["outer"] - dur["a"] - dur["b"])
    assert tot["a"] == (1, dur["a"], dur["a"] - dur["c"])
    assert tot["c"] == (1, dur["c"], dur["c"])
    # a later record is read on its own from its index on
    assert set(profiling.totals(since=3)) == {"b"}


def test_records_lie_on_the_profilers_clock():
    """Each span is an ``asr/`` host range in the profile; the tracer's
    own `time.time_ns()` stamps lie within 5 ms of the range's ends."""
    with cpu_profile() as prof:
        for i in range(5):
            with profiling.span("clock", i):
                torch.ones(256, 256) @ torch.ones(256, 256)
    ranges = sorted(
        (e.start_ns(), e.start_ns() + e.duration_ns())
        for e in prof.profiler.kineto_results.events()
        if e.name() == "asr/clock")
    recs = by_name("clock")
    assert len(ranges) == len(recs) == 5
    for (r0, r1), rec in zip(ranges, recs):
        assert abs(rec.start_ns - r0) < 5e6
        assert abs(rec.end_ns - r1) < 5e6


def test_counters_and_reset():
    profiling.count("k")
    with cpu_profile():
        profiling.count("k", 4)
        with profiling.span("s"):
            pass
    profiling.count("k", 10)
    assert profiling.counter("k") == 15
    assert profiling.counter("k", traced=True) == 4
    assert profiling.counter("never") == 0
    assert len(profiling.spans()) == 1
    profiling.reset()
    assert profiling.counter("k") == 0
    assert profiling.counter("k", traced=True) == 0
    assert profiling.spans() == []


def test_summary_lists_spans_then_counters():
    with cpu_profile():
        for _ in range(3):
            with profiling.span("s"):
                with profiling.span("t"):
                    pass
    profiling.count("bytes", 5)
    lines = profiling.TRACER.summary().splitlines()
    assert lines[0].split() == ["span", "count", "total", "ms", "self",
                                "ms"]
    assert [ln.split()[:2] for ln in lines[1:3]] == [["s", "3"],
                                                     ["t", "3"]]
    assert lines[-1] == "  counter bytes 5"


def test_estep_spans_and_frame_counters(tmp_path):
    """`run_recipe_batched` on a 3-utterance recipe: every stage span
    under ``estep.shard``, one per utterance or per batch, and
    ``estep.frames`` equal to the frames the statistics hold."""
    from tests.test_torch_train import _models, write_corpus
    recipe = write_corpus(tmp_path, np.random.default_rng(4))
    _, model = _models(seed=5)
    drv = EStepDriver(model, str(tmp_path / "feats.cfg"), device="cpu")
    with cpu_profile():
        stats = drv.run_recipe_batched(Recipe.read(str(recipe)),
                                       batch_size=2)
    tot = profiling.totals()
    n_utt = 3
    (shard,) = by_name("estep.shard")
    assert tot["estep.shard"][0] == 1
    for name in ("estep.read", "estep.features", "estep.compile"):
        assert tot[name][0] == n_utt, name
    n_batch = tot["estep.batch"][0]
    assert n_batch >= 2
    for name in ("estep.fetch", "estep.accumulate"):
        assert tot[name][0] == n_batch, name
    assert tot["estep.upload"][0] >= n_batch
    recs = profiling.spans()
    for r in recs:
        if r.name.startswith("estep.") and r.name != "estep.shard":
            assert recs[r.parent].name == "estep.shard", r.name
    assert stats.num_frames == profiling.counter("estep.frames") > 0
    padded = profiling.counter("estep.padded_frames")
    assert padded >= stats.num_frames and padded % drv.time_bucket == 0


def test_features_range_counts_the_uploaded_buffer():
    """Each `features_range` call over a growing host buffer adds the
    whole buffer's float32 bytes to ``frontend.upload_bytes``; samples
    already on the device add nothing."""
    fg = FeatureGenerator(FeatureConfig.parse(MFCC_CFG), device="cpu")
    rng = np.random.default_rng(3)
    buf = np.zeros(0, np.float32)
    with cpu_profile():
        for k in range(1, 5):
            buf = np.concatenate(
                [buf, rng.normal(0, 1000, 1600).astype(np.float32)])
            before = profiling.counter("frontend.upload_bytes")
            fg.features_range(buf, 0, fg.num_frames(len(buf)))
            assert (profiling.counter("frontend.upload_bytes") - before
                    == 4 * len(buf))
        total = profiling.counter("frontend.upload_bytes", traced=True)
        fg.features_range(torch.as_tensor(buf), 0, 4)
    assert total == 4 * 1600 * (1 + 2 + 3 + 4)
    assert profiling.counter("frontend.upload_bytes", traced=True) == total
    assert profiling.totals()["frontend.features"][0] == 5


def _decode_task():
    model, tree, fsa = make_decode_task()
    obs = np.array(synth_obs(tree, model, ["_", "a", "b", "b", "a", "_"],
                             noise=0.5, seed=0))
    return model, tree, fsa, obs


def _phase_parents(phases, parent):
    recs = profiling.spans()
    for r in recs:
        if r.name in phases:
            assert recs[r.parent].name == parent, r.name


def test_dense_decode_phase_spans_once_per_frame():
    from aaltoasr_tpu.decoder.search import SearchConfig as JConfig
    model, tree, fsa, obs = _decode_task()
    cfg = JConfig(num_tokens=256, num_records=16, beam=1e9, lm_scale=1.0)
    search = DenseBeamSearch(
        convert.prefix_tree(tree), convert.ngram_fsa(fsa),
        convert.hmm_model(model), convert.search_config(cfg), device="cpu")
    T = obs.shape[0]
    batch = np.stack([obs, obs])
    with cpu_profile():
        res = search.decode_batch(batch, [T, T - 3], lattice=False)
    assert res[0].words == search.decode(obs).words
    tot = profiling.totals()
    phases = ("dense.arcs", "dense.words", "dense.reentry", "dense.beam")
    for name in ("dense.step",) + phases:
        assert tot[name][0] == T - 1, name
    for name in ("dense.decode", "dense.fetch", "dense.traceback"):
        assert tot[name][0] == 1, name
    _phase_parents(phases, "dense.step")
    _phase_parents(("dense.step", "dense.fetch", "dense.traceback"),
                   "dense.decode")
    inner = sum(tot[n][1] for n in phases) + tot["dense.step"][2] + sum(
        tot[n][1] for n in ("dense.fetch", "dense.traceback"))
    assert inner + tot["dense.decode"][2] == tot["dense.decode"][1]


def _exact_search():
    from aaltoasr_tpu.decoder.search import SearchConfig as JConfig
    model, tree, fsa, obs = _decode_task()
    cfg = JConfig(num_tokens=128, num_records=16, beam=1e9, lm_scale=1.0)
    search = BeamSearch(convert.prefix_tree(tree), convert.ngram_fsa(fsa),
                        convert.hmm_model(model),
                        convert.search_config(cfg), device="cpu")
    return search, obs


EXACT = ("exact.expand", "exact.words", "exact.prune")


def test_stream_push_phase_spans_once_per_frame():
    """Blocks of 4 frames: one ``stream.push`` and one
    ``stream.partial`` a block, and the exact step's three phases once
    a frame after the first (which seeds the tokens)."""
    search, obs = _exact_search()
    sd = StreamingDecoder(search)
    T = obs.shape[0]
    blocks = range(0, T, 4)
    with cpu_profile():
        for lo in blocks:
            sd.push_frames(obs[lo:lo + 4])
            sd.partial()
    assert sd.result().words == search.decode(obs).words
    tot = profiling.totals()
    assert tot["stream.push"][0] == tot["stream.partial"][0] == len(blocks)
    for name in EXACT:
        assert tot[name][0] == T - 1, name
    _phase_parents(EXACT, "stream.push")
    units = [r.unit for r in by_name("stream.push")]
    assert units == list(blocks)


def test_exact_decode_batch_phase_spans_once_per_frame():
    search, obs = _exact_search()
    with cpu_profile():
        search.decode_batch(obs[None], [obs.shape[0]], lattice=False)
    tot = profiling.totals()
    for name in EXACT:
        assert tot[name][0] == obs.shape[0] - 1, name
    assert {r.parent for r in profiling.spans()} == {-1}
