"""The traffic generators: deterministic per seed, as distributed as
stated, and plans that fill their utterances exactly."""

import numpy as np
import pytest
import torch

from portbench.traffic import audio, models, plan
from portbench.traffic.task import chain_task, decode_task

LENGTHS = {"count": 512, "median_s": 6.0, "sigma": 0.5, "lo_s": 2.0,
           "hi_s": 15.0, "set_seed": 16}


@pytest.fixture(scope="module")
def task():
    return decode_task(num_words=60)


def test_lengths_are_one_set_in_another_order():
    a = plan.run_lengths(LENGTHS, 125.0, 3000000011)
    b = plan.run_lengths(LENGTHS, 125.0, 3000000011)
    c = plan.run_lengths(LENGTHS, 125.0, 2 ** 31 + 5)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    assert np.array_equal(np.sort(a), np.sort(c))


def test_each_unit_is_the_set_in_its_own_order():
    a = plan.run_lengths(dict(LENGTHS, count=48, units=4), 125.0, 2 ** 31 + 5)
    units = a.reshape(4, 48)
    assert all(np.array_equal(np.sort(u), np.sort(units[0])) for u in units)
    assert not np.array_equal(units[0], units[1])
    # one unit is the order of a run without units
    assert np.array_equal(units[0], plan.run_lengths(
        dict(LENGTHS, count=48), 125.0, 2 ** 31 + 5))


def test_lengths_follow_the_stated_distribution():
    s = plan.length_set(20000, 6.0, 0.5, 2.0, 15.0, 125.0, 1) / 125.0
    assert s.min() >= 2.0 and s.max() <= 15.0
    assert abs(np.median(s) - 6.0) < 0.1
    inner = np.log(s[(s > 2.0) & (s < 15.0)] / 6.0)
    # the clipped tails leave the central spread of N(0, 0.5^2)
    q1, q3 = np.quantile(inner, [0.25, 0.75])
    assert abs((q3 - q1) / 1.349 - 0.5) < 0.03


def test_task_is_the_programs_operating_point():
    t = decode_task()
    assert t["num_states"] == 2704
    assert len(t["ngrams"][2]) <= 10000 and len(t["ngrams"][3]) <= 20000
    assert len(t["words"]) == 1000


@pytest.mark.parametrize("T", [250, 751, 1875])
def test_word_plans_fill_whole_words(task, T):
    rng = np.random.default_rng(7)
    p, words = plan.word_plan(task, T, rng)
    assert len(p) == T and words
    # every planted word's states appear in order
    assert set(np.unique(p)) <= set(range(task["num_states"]))


def test_plans_are_deterministic_per_seed(task):
    lens = np.asarray([300, 400])
    a = plan.plans(task, lens, 3000000011, "words")
    b = plan.plans(task, lens, 3000000011, "words")
    c = plan.plans(task, lens, 12, "words")
    assert all(np.array_equal(x, y) for x, y in zip(a[0], b[0]))
    assert a[1] == b[1] and a[1] != c[1]


@pytest.mark.parametrize("T", [250, 999])
def test_phone_plans_fill_their_frames(T):
    t = chain_task(100)
    p, labels = plan.phone_plan(t, T, np.random.default_rng(3))
    assert len(p) == T
    chain = [s for lbl in labels for s in t["phones"][lbl]]
    # the plan visits the chain's states in order, each at least once
    runs = [int(s) for i, s in enumerate(p) if i == 0 or p[i - 1] != s]
    assert runs == chain


def test_phone_plans_have_one_chain_length_a_length():
    t = chain_task(100)
    rate = plan.phone_frames(t)
    assert abs(rate - (1 / 0.3 + 1 / 0.4)) < 1e-9
    for T in (250, 751, 1875):
        n = {len(plan.phone_plan(t, T, np.random.default_rng(s))[1])
             for s in range(5)}
        assert n == {round(T / rate)}


def test_audio_is_deterministic_and_pcm():
    sig = audio.signatures(10, [0], 5)
    plans = [np.asarray([1, 2, 3] * 10, np.int32), np.asarray([0] * 12)]
    a, n = audio.synthesize(plans, sig, 5, "cpu")
    b, _ = audio.synthesize(plans, sig, 5, "cpu")
    assert torch.equal(a, b)
    assert list(n) == [audio.num_samples(30), audio.num_samples(12)]
    assert torch.equal(a, a.round()) and float(a.abs().max()) <= 32768
    assert float(a[1, n[1]:].abs().max()) == 0.0
    # the quiet state is quiet
    assert float(a[1, :n[1]].std()) < 0.2 * float(a[0, :n[0]].std())


def test_placed_gaussians_sit_on_their_states():
    g = torch.Generator().manual_seed(0)
    states = torch.arange(4).repeat_interleave(50)
    feats = torch.randn(200, 3, generator=g, dtype=torch.float64) * 0.1 \
        + states[:, None].double() * 10
    comp, w = models.mixtures(4, 8, 2, False, 9)
    means, var = models.place(comp, 8, feats, states, 9)
    assert np.allclose(w.sum(1), 1.0)
    for s in range(4):
        assert np.all(np.abs(means[comp[s]] - 10 * s) < 2.0)
    a = models.place(comp, 8, feats, states, 9)
    assert np.array_equal(a[0], means) and np.array_equal(a[1], var)
