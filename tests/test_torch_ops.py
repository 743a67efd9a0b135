"""PyTorch port, scoring ops: log-semiring helpers, GMM scoring, LNA
codes and the fused GMM kernel's plain version, against the JAX package
on the same numpy inputs (CPU)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aaltoasr_tpu.ops import logsemiring as J_ls
from aaltoasr_tpu.ops.gmm import GmmScorer as JGmm
from aaltoasr_tpu.ops.gmm import quantize_lna_u16 as j_quantize
from aaltoasr_tpu.ops.gmm_pallas import FusedGmmScorer as JFused

from aaltoasr_tpu_torch import convert
from aaltoasr_tpu_torch.ops import logsemiring as T_ls
from aaltoasr_tpu_torch.ops.gmm import GmmScorer as TGmm
from aaltoasr_tpu_torch.ops.gmm import quantize_lna_u16 as t_quantize
from aaltoasr_tpu_torch.ops.gmm_cuda import (
    FusedGmmScorer as TFused, gmm_state_ll, reference_state_ll)
from aaltoasr_tpu_torch.utils import profiling

from tests.test_gmm import random_model

# the tests run tiny tensors in several worker processes at once: one
# intra-op thread each avoids oversubscribing the cores
torch.set_num_threads(1)


def _np(x):
    return np.asarray(x)


class TestLogSemiring:
    def test_constants(self):
        assert T_ls.LOG_ZERO == J_ls.LOG_ZERO
        assert T_ls.SAFE_LOG_FLOOR == J_ls.SAFE_LOG_FLOOR

    def test_elementwise(self):
        rng = np.random.default_rng(0)
        a = rng.normal(0, 30, 64).astype(np.float32)
        b = rng.normal(0, 30, 64).astype(np.float32)
        a[:8] = J_ls.LOG_ZERO
        b[4:12] = J_ls.LOG_ZERO
        # one libm-level rounding apart at most
        np.testing.assert_allclose(
            T_ls.logaddexp(torch.tensor(a), torch.tensor(b)).numpy(),
            _np(J_ls.logaddexp(a, b)), rtol=1e-6)
        x = np.abs(a) * np.float32(1e-30)
        np.testing.assert_allclose(T_ls.safe_log(torch.tensor(x)).numpy(),
                                   _np(J_ls.safe_log(x)), rtol=1e-6)

    @pytest.mark.parametrize("masked", [False, True])
    def test_logsumexp(self, masked):
        rng = np.random.default_rng(1)
        x = rng.normal(0, 10, (6, 9)).astype(np.float32)
        where = rng.random((6, 9)) > 0.5 if masked else None
        if masked:
            where[2] = False                      # fully masked row
        got = T_ls.logsumexp(torch.tensor(x), dim=-1, where=(
            None if where is None else torch.tensor(where))).numpy()
        want = _np(J_ls.logsumexp(x, axis=-1, where=where))
        np.testing.assert_allclose(got, want, rtol=1e-6)
        if masked:
            assert got[2] == T_ls.LOG_ZERO


def _feats(T, D, seed):
    return np.random.default_rng(seed).normal(0, 2, (T, D)).astype(
        np.float32)


class TestGmmScoring:
    # summation order differs between XLA and torch matmuls: atol 1e-3
    # at D=39 (|ll| in the hundreds), 1e-4 at D=7
    @pytest.mark.parametrize("D,atol", [(39, 1e-3), (7, 1e-4)])
    def test_state_log_likelihoods(self, D, atol):
        model = random_model(G=60, S=21, D=D, K=5, seed=D)
        x = _feats(33, D, seed=3)
        want = _np(JGmm.from_model(model).state_log_likelihoods(x))
        got = TGmm.from_model(convert.hmm_model(model), device="cpu"
                              ).state_log_likelihoods(torch.tensor(x))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy()[:, :21], want[:, :21],
                                   rtol=0, atol=atol)

    def test_tables_equal_reference(self):
        model = random_model(G=50, S=13, D=7, K=4, seed=4)
        j = JGmm.from_model(model)
        t = TGmm.from_model(convert.hmm_model(model), device="cpu")
        c = convert.gmm_scorer(j)          # the reference's tables, carried
        for name in ("score_matrix", "score_bias", "comp_idx", "comp_logw"):
            np.testing.assert_array_equal(getattr(t, name).numpy(),
                                          _np(getattr(j, name)))
            np.testing.assert_array_equal(getattr(c, name).numpy(),
                                          getattr(t, name).numpy())

    def test_lna_codes_within_one_step(self):
        model = random_model(G=80, S=40, D=39, K=6, seed=5)
        x = _feats(200, 39, seed=6)
        want = _np(j_quantize(JGmm.from_model(model).lna_log_probs(x)))
        got = t_quantize(TGmm.from_model(convert.hmm_model(model), device="cpu")
                         .lna_log_probs(torch.tensor(x))).numpy()
        diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
        assert diff.max() <= 1
        assert (diff == 0).mean() >= 0.99

    def test_quantize_edges(self):
        lp = np.array([[0.0, -1e-4, -2.5, -36.0, -36.0081, -50.0,
                        -1e30]], np.float32)
        np.testing.assert_array_equal(t_quantize(torch.tensor(lp)).numpy(),
                                      _np(j_quantize(lp)).astype(np.int64))

    def test_unported_models_raise(self):
        """Nothing is left unported: a full-covariance model builds and
        scores as the reference does (atol 1e-4 at D=7)."""
        model = random_model(D=7)
        model.cov_type = "full_cov"
        x = _feats(9, 7, seed=13)
        want = _np(JGmm.from_model(model).state_log_likelihoods(x))
        got = TGmm.from_model(convert.hmm_model(model), device="cpu")
        assert got.full_cov
        np.testing.assert_allclose(
            got.state_log_likelihoods(torch.tensor(x)).numpy()[:, :11],
            want[:, :11], rtol=0, atol=1e-4)


class TestFusedGmmPlain:
    """The K1 kernel's plain version against the Pallas kernel run in
    interpret mode (as tests/test_gmm_fused.py runs it)."""

    @pytest.mark.parametrize("D,K,atol", [(7, 3, 1e-4), (39, 8, 1e-3)])
    def test_matches_pallas_interpret(self, D, K, atol):
        model = random_model(G=70, S=19, D=D, K=K, seed=7)
        jf = JFused.from_scorer(JGmm.from_model(model))
        tf = TFused.from_scorer(TGmm.from_model(convert.hmm_model(model),
                                                device="cpu"))
        np.testing.assert_array_equal(tf.we.numpy(), _np(jf.we))
        np.testing.assert_array_equal(convert.fused_gmm_scorer(jf).we.numpy(),
                                      tf.we.numpy())
        x = _feats(37, D, seed=8)
        want = _np(jf.state_log_likelihoods(jnp.asarray(x), interpret=True))
        got = gmm_state_ll(torch.tensor(x), tf.we, D).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got[:, :19], want[:, :19], rtol=0,
                                   atol=atol)
        # padded state columns stay at LOG_ZERO
        assert (got[:, 19:] <= -1e29).all()

    def test_fused_lna_matches_plain_scorer(self):
        model = convert.hmm_model(random_model(G=50, S=12, D=7, seed=9))
        sc = TGmm.from_model(model, device="cpu")
        x = torch.tensor(_feats(20, 7, seed=10))
        np.testing.assert_allclose(
            TFused.from_scorer(sc).lna_log_probs(x).numpy(),
            sc.lna_log_probs(x).numpy(), rtol=0, atol=1e-4)

    def test_cpu_wrapper_is_the_plain_version(self):
        model = convert.hmm_model(random_model(G=30, S=9, D=7, seed=11))
        tf = TFused.from_scorer(TGmm.from_model(model, device="cpu"))
        x = torch.tensor(_feats(12, 7, seed=12))
        before = profiling.counter("k1.launches")
        np.testing.assert_array_equal(gmm_state_ll(x, tf.we, 7).numpy(),
                                      reference_state_ll(x, tf.we, 7).numpy())
        assert profiling.counter("k1.launches") == before
