"""PyTorch port, decoder: LM walk, tie order of the top-k selections and
the dense beam search, against the JAX package on the same inputs (CPU).

1-best words must be identical and log-probs within rel 1e-4 (float32
elementwise math in another library)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aaltoasr_tpu.decoder.ngram import lm_walk_device as j_walk
from aaltoasr_tpu.decoder.search import SearchConfig as JConfig
from aaltoasr_tpu.decoder.search_dense import DenseBeamSearch as JDense

from aaltoasr_tpu_torch import convert, synth
from aaltoasr_tpu_torch.decoder.ngram import (
    NGramFsa, hash_bucket, lm_walk_device)
from aaltoasr_tpu_torch.decoder.search import top_k
from aaltoasr_tpu_torch.decoder.search_dense import DenseBeamSearch

from tests.test_decoder import make_decode_task, synth_obs

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmarks"))
import bench_decode  # noqa: E402

# the tests run tiny tensors in several worker processes at once: one
# intra-op thread each avoids oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def xw_task():
    """A small cross-word triphone task with durations and a trigram
    LM, built by both sides from the same seed."""
    model, tree, fsa = bench_decode.synth_task(
        num_words=30, order=3, triphone=True, durations=True)
    info = bench_decode.synth_task.last_info
    return model, tree, fsa, info, synth.synth_task(
        num_words=30, order=3, triphone=True, durations=True)


class TestLmWalk:
    def test_hash_bucket_ids_equal_reference(self, xw_task):
        fsa = xw_task[2]
        tabs = fsa.device_tables()
        mask = int(tabs["hash_mask"])
        rng = np.random.default_rng(0)
        s = rng.integers(0, 2**31 - 1, 5000)
        w = rng.integers(0, 2**31 - 1, 5000)
        s[:3] = [0, 2**31 - 1, fsa.num_states - 1]
        want = ((s.astype(np.uint32) * np.uint32(2654435761))
                ^ (w.astype(np.uint32) * np.uint32(40503))) & np.uint32(mask)
        # the reference's own device formula
        jwant = ((jnp.asarray(s).astype(jnp.uint32) * jnp.uint32(2654435761))
                 ^ (jnp.asarray(w).astype(jnp.uint32) * jnp.uint32(40503))
                 ) & jnp.uint32(mask)
        got = hash_bucket(torch.tensor(s), torch.tensor(w), mask).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))
        np.testing.assert_array_equal(got, np.asarray(jwant).astype(np.int64))

    def test_tables_equal_reference(self, xw_task):
        fsa, tfsa = xw_task[2], xw_task[4].fsa
        for name in ("trans_word", "trans_prob", "trans_next",
                     "state_first", "bo_weight", "bo_next"):
            np.testing.assert_array_equal(getattr(tfsa, name),
                                          getattr(fsa, name))
        packed = np.asarray(fsa.device_tables()["hash_packed"])
        h = tfsa.hash_tables()
        L = h["hash_state"].shape[1]
        cols = packed.reshape(packed.shape[0], L, 4)
        np.testing.assert_array_equal(
            h["hash_state"], cols[..., 0].view(np.int32))
        np.testing.assert_array_equal(
            h["hash_word"], cols[..., 1].view(np.int32))
        np.testing.assert_array_equal(
            h["hash_next"], cols[..., 2].view(np.int32))
        np.testing.assert_array_equal(h["hash_prob"], cols[..., 3])

    def test_walk_equals_reference(self, xw_task):
        fsa = xw_task[2]
        tfsa = convert.ngram_fsa(fsa)
        rng = np.random.default_rng(1)
        states = rng.integers(0, fsa.num_states, 3000).astype(np.int32)
        words = rng.integers(0, fsa.num_words, 3000).astype(np.int32)
        jn, js = jax.jit(lambda s, w: j_walk(
            fsa.device_tables(), fsa.num_words, fsa.order, s, w))(
                jnp.asarray(states), jnp.asarray(words))
        tn, ts = lm_walk_device(tfsa.device_tables(), tfsa.order,
                                torch.tensor(states), torch.tensor(words))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        for i in range(0, 3000, 97):      # and the host walk
            n, sc = fsa.walk(int(states[i]), int(words[i]))
            assert int(tn[i]) == n
            assert float(ts[i]) == pytest.approx(sc, rel=1e-6, abs=1e-5)

    def test_from_arpa_via_convert(self, xw_task):
        assert isinstance(convert.ngram_fsa(xw_task[2]), NGramFsa)


def test_top_k_tie_order_matches_lax():
    """Ties resolve to the lower index first, as jax.lax.top_k does
    (torch.topk promises no order among equal values)."""
    x = np.array([[3.0, 1.0, 3.0, -np.inf, 3.0, 1.0, -np.inf, 2.0],
                  [-np.inf] * 8,
                  [0.5, 0.5, 0.5, 0.5, 0.7, 0.5, 0.5, 0.5]], np.float32)
    for k in (1, 3, 5, 8):
        _, want = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(top_k(torch.tensor(x), k).numpy(),
                                      np.asarray(want))


class TestDenseDecode:
    CASES = [(0, ["_", "a", "b", "b", "a", "_"], 0.5),
             (1, ["c", "a", "a", "b"], 0.5),
             (2, ["b", "a", "c", "a"], 0.5),
             (3, ["a", "b", "b", "a"], 2.5)]

    @pytest.mark.parametrize("require_end", [True, False])
    def test_matches_reference(self, require_end):
        model, tree, fsa = make_decode_task()
        cfg = JConfig(num_tokens=256, num_records=16, beam=1e9,
                      lm_scale=1.0, require_sentence_end=require_end)
        ref = JDense(tree, fsa, model, cfg)
        port = DenseBeamSearch(
            convert.prefix_tree(tree), convert.ngram_fsa(fsa),
            convert.hmm_model(model), convert.search_config(cfg),
            device="cpu")
        for seed, seq, noise in self.CASES:
            obs = np.array(synth_obs(tree, model, seq, noise=noise,
                                     seed=seed))
            r1 = ref.decode(obs)
            r2 = port.decode(obs)
            assert r2.words == r1.words, seq
            assert r2.log_prob == pytest.approx(r1.log_prob, rel=1e-4)

    def test_batch_matches_reference(self):
        model, tree, fsa = make_decode_task()
        cfg = JConfig(num_records=16, beam=1e9, lm_scale=1.0,
                      require_sentence_end=True)
        obs1 = np.array(synth_obs(tree, model, ["a", "b", "_"], seed=3))
        obs2 = np.array(synth_obs(tree, model, ["c", "a"], seed=4))
        T = max(obs1.shape[0], obs2.shape[0])
        pad = np.full((2, T, obs1.shape[1]), -100.0, dtype=np.float32)
        pad[0, :obs1.shape[0]] = obs1
        pad[1, :obs2.shape[0]] = obs2
        n = np.array([obs1.shape[0], obs2.shape[0]])
        ref = JDense(tree, fsa, model, cfg).decode_batch(pad, n,
                                                         lattice=False)
        port = DenseBeamSearch(
            convert.prefix_tree(tree), convert.ngram_fsa(fsa),
            convert.hmm_model(model), convert.search_config(cfg),
            device="cpu")
        got = port.decode_batch(pad, n)
        single = [port.decode(obs1), port.decode(obs2)]
        for r, g, s in zip(ref, got, single):
            assert g.words == r.words == s.words
            assert g.log_prob == pytest.approx(r.log_prob, rel=1e-4)

    @pytest.mark.parametrize("require_end", [False, True])
    def test_crossword_task_matches_reference(self, xw_task, require_end):
        """Cross-word triphones, gamma durations (scale 3), trigram LM:
        the bench's operating point at 30 words.  The port builds its
        own task from the seed; its tables equal the reference's."""
        model, tree, fsa, info, task = xw_task
        for f in ("pdf", "arc_tgt", "arc_logp", "we_word", "we_exit_logp",
                  "we_pair", "root_pair_tgt", "root_pair_logp"):
            np.testing.assert_array_equal(getattr(task.tree, f),
                                          getattr(tree, f))
        B, T = 3, 320
        obs_fn, true_words = bench_decode.synth_obs(model, info, B, T)
        plan, port_words = synth.synth_obs(task.model, task.info, B, T)
        assert port_words == true_words
        obs = np.array(jax.jit(obs_fn)(jax.random.PRNGKey(1)))
        # the reference planted the same states: gain 8 over N(-5, 2^2)
        # noise makes the plan the argmax far above chance (1/S)
        assert (obs.argmax(-1) == plan).mean() > 0.5
        cfg = JConfig(lm_scale=30.0, duration_scale=3.0, num_records=32,
                      require_sentence_end=require_end)
        n = np.array([T, T - 40, T - 90])
        ref = JDense(tree, fsa, model, cfg).decode_batch(obs, n,
                                                         lattice=False)
        got = DenseBeamSearch(task.tree, task.fsa, task.model,
                              convert.search_config(cfg),
                              device="cpu").decode_batch(obs, n)
        assert any(r.words for r in ref)
        for r, g in zip(ref, got):
            assert g.words == r.words
            assert g.log_prob == pytest.approx(r.log_prob, rel=1e-4)

    def test_lattice_not_ported(self):
        """lattice=False leaves the records on the device (the result
        has none, and no word graph); lattice=True brings the
        reference's records, scores within rtol 1e-5, atol 1e-3."""
        model, tree, fsa = make_decode_task()
        cfg = JConfig(num_records=16, beam=1e9, lm_scale=1.0)
        port = DenseBeamSearch(convert.prefix_tree(tree),
                               convert.ngram_fsa(fsa),
                               convert.hmm_model(model),
                               convert.search_config(cfg), device="cpu")
        obs = np.array(synth_obs(tree, model, ["a", "b", "c", "a"], seed=2))
        fast = port.decode(obs, lattice=False)
        assert fast.rec_words is None and fast.rec_ams is None
        with pytest.raises(RuntimeError, match="lattice=False"):
            fast.word_graph()
        ref = JDense(tree, fsa, model, cfg).decode(obs, lattice=True)
        got = port.decode(obs, lattice=True)
        assert got.words == fast.words == ref.words
        np.testing.assert_array_equal(got.rec_words, ref.rec_words)
        np.testing.assert_array_equal(got.rec_prevs, ref.rec_prevs)
        for f in ("rec_ams", "rec_lmss"):
            np.testing.assert_allclose(getattr(got, f), getattr(ref, f),
                                       rtol=1e-5, atol=1e-3)
