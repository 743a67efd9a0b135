"""PyTorch port, full-covariance LNA codes on large model-space CMLLR
transforms: the JAX package's `GmmScorer`, the port's (CPU) and the
exact float64 codes (`synth.exact_lna_codes`: the centred form straight
from the folded model's means and full covariances, no scorer table).

The pools are folded by each package's `apply_model_cmllr` from the same
numpy diagonal pool and transforms, at D=39.  ``wide`` is built like the
transforms that `recognize --adapt cmllr` estimates on two synthetic
speakers: entries to ~3.3, precision entries to ~390.  There the
expanded square ``[vec(x x'), x] @ A`` cancels: in float32 it rounds
codes several steps off the exact ones, on both packages.  The port
forms that product in float64 and meets the LNA-code contract (within
one step, >= 99% identical) against the exact codes.  Where the JAX
package itself misses the contract against the exact codes (``wide``),
the port is held to the JAX package within the JAX package's own
distance from the exact codes; where the JAX package meets it
(``near``: transforms near the identity), the port is held to the JAX
package by the contract itself.
"""

import dataclasses

import numpy as np
import pytest
import torch

from aaltoasr_tpu.formats import model_io as J_io
from aaltoasr_tpu.ops.gmm import GmmScorer as JGmm
from aaltoasr_tpu.ops.gmm import quantize_lna_u16 as j_quantize
from aaltoasr_tpu.train.mllr import apply_model_cmllr as j_model_cmllr

from aaltoasr_tpu_torch import convert
from aaltoasr_tpu_torch.ops.gmm import GmmScorer as TGmm
from aaltoasr_tpu_torch.ops.gmm import quantize_lna_u16 as t_quantize
from aaltoasr_tpu_torch.synth import exact_lna_codes
from aaltoasr_tpu_torch.train.mllr import apply_model_cmllr as t_model_cmllr

torch.set_num_threads(1)

D, G, S, K, T, CLASSES = 39, 400, 100, 4, 400, 2


def _pool(kind: str, seed: int = 0):
    """(diagonal JAX model, transforms, class per Gaussian, features):
    Gaussians placed on N(0, 1) frames, the features those frames under
    class 0's inverse transform (the speaker's features, on which the
    adapted pool is peaked)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (T, D))
    means = x[rng.choice(T, G)] + rng.normal(0, 0.3, (G, D))
    var = 0.08 if kind == "wide" else 0.25
    covars = var * rng.uniform(0.5, 2.0, (G, D))
    mixtures = [(rng.choice(G, K, replace=False).astype(np.int32),
                 rng.dirichlet(np.ones(K))) for _ in range(S)]
    model = J_io.HmmModel(dim=D, cov_type="diagonal_cov", means=means,
                          covars=covars, mixtures=mixtures, phones=[],
                          transitions={})
    Ws = []
    for _ in range(CLASSES):
        if kind == "wide":
            A = (np.diag(rng.uniform(0.6, 3.2, D))
                 + rng.normal(0, 0.3, (D, D)))
        else:
            A = np.eye(D) + 0.05 * rng.normal(0, 1, (D, D))
        b = rng.normal(0, 0.5, D)
        Ws.append(np.concatenate([b[:, None], A], axis=1))
    cls = rng.integers(0, CLASSES, G)
    feats = np.linalg.solve(Ws[0][:, 1:], (x - Ws[0][:, 0]).T).T
    return model, Ws, cls, feats.astype(np.float32)


def _distance(a, b):
    """(share of codes identical, largest step)."""
    d = np.abs(a - b)
    return float((d == 0).mean()), int(d.max())


def _meets(dist) -> bool:
    """The LNA-code contract: within one step, >= 99% identical."""
    return dist[1] <= 1 and dist[0] >= 0.99


@pytest.mark.parametrize("kind", ["wide", "near"])
def test_fullcov_codes_against_exact(kind):
    model, Ws, cls, x = _pool(kind)
    jm = j_model_cmllr(model, Ws, cls)
    tm = t_model_cmllr(convert.hmm_model(model), Ws, cls)
    prec = max(float(np.abs(np.linalg.inv(c)).max())
               for c in tm.full_covars.values())
    if kind == "wide":
        assert max(float(np.abs(W[:, 1:]).max()) for W in Ws) > 3.2
        assert 350 < prec < 450
    jax = np.asarray(j_quantize(JGmm.from_model(jm).lna_log_probs(x)),
                     dtype=np.int64)
    scorer = TGmm.from_model(tm, device="cpu")
    port = t_quantize(scorer.lna_log_probs(torch.tensor(x))).numpy().astype(
        np.int64)
    # the product in float32, as before the repair: the same code on
    # float32 tables
    f32 = dataclasses.replace(scorer,
                              score_matrix=scorer.score_matrix.float(),
                              score_bias=scorer.score_bias.float())
    port32 = t_quantize(f32.lna_log_probs(torch.tensor(x))).numpy().astype(
        np.int64)
    exact = exact_lna_codes(tm, x)
    d_pe, d_je, d_pj, d_fe = (_distance(a, b) for a, b in (
        (port, exact), (jax, exact), (port, jax), (port32, exact)))
    print(f"\n{kind}: precision entries to {prec:.1f}; identical share, "
          f"largest step: port-exact {d_pe}, JAX-exact {d_je}, port-JAX "
          f"{d_pj}, float32 form-exact {d_fe}")
    assert _meets(d_pe)
    if kind == "wide":
        # the expanded square cancels in float32: the JAX package and the
        # port's float32 form both miss the contract (ROADMAP Queue 3,
        # quirks of the reference kept out of the port)
        assert not _meets(d_je) and not _meets(d_fe)
        assert 1 - d_pj[0] <= 1 - d_je[0] and d_pj[1] <= d_je[1]
    else:
        assert _meets(d_je) and _meets(d_pj)


def test_exact_codes_branches_agree():
    """`exact_lna_codes` gives a diagonal pool the same codes through its
    diagonal branch and through its full-covariance branch (the pool's
    covariances as diagonal matrices), and the port's float32 diagonal
    scorer meets the contract against them."""
    model, _, _, x = _pool("near")
    tm = convert.hmm_model(model)
    full = dataclasses.replace(
        tm, cov_type="variable", gauss_kind=["full"] * G,
        full_covars={g: np.diag(tm.covars[g]) for g in range(G)})
    exact = exact_lna_codes(tm, x)
    assert _distance(exact_lna_codes(full, x), exact) == (1.0, 0)
    port = t_quantize(TGmm.from_model(tm, device="cpu").lna_log_probs(
        torch.tensor(x))).numpy().astype(np.int64)
    assert _meets(_distance(port, exact))
