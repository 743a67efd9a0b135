"""The forward-backward kernel (`ops/fb_cuda.py`, `csrc/chain_fb.cu`)
against the plain loops it replaces, on the same card, and its dispatch
(`train/estep._recursions`) on the CPU.

The kernel computes each graph form's recursion in that form's order
(the gather loops, or the shift form's loops on a shift-compiled graph)
in float32 with IEEE exp and log; torch's own reductions may sum in
another order, so the two may differ by float32 rounding: totals rel
1e-5, rows within 1e-4 of each utterance's largest magnitude, the same
reachable positions, and frozen rows equal to the row they repeat.
That holds at every shared-memory plan: rows, ring and tables in shared
memory, the tables in device memory, and nothing in shared memory (P
above 5,811, as an MMI denominator's 8,192).  End to end, `chain_stats`
on the card (the kernel) stays within the same-input tolerances of
`chip_smoke.py`'s card-against-CPU checks of `chain_stats` on the CPU
(the plain loops), in both graph forms.  Tests marked `cuda` need a
CUDA device and skip without one; on the GPU host run

    python -m pytest --noconftest tests/test_torch_fb_cuda.py

This file imports no jax.
"""

import types

import numpy as np
import pytest
import torch

from aaltoasr_tpu_torch.ops import fb_cuda
from aaltoasr_tpu_torch.ops.cuda_build import SMEM_LIMIT
from aaltoasr_tpu_torch.ops.gmm import GmmScorer
from aaltoasr_tpu_torch.synth import random_model
from aaltoasr_tpu_torch.train import estep
from aaltoasr_tpu_torch.utils import profiling

LOG_ZERO = estep.LOG_ZERO
NUM_SLOTS = 16
# the largest P whose fan tables (F = 4) still fit beside the rows, and
# the largest P whose rows fit at all; above it nothing is in shared
# memory
ROWS = 4 * (2 + fb_cuda.RING)
P_TABLES = SMEM_LIMIT // (ROWS + 8 * 4)
P_ROWS = SMEM_LIMIT // ROWS


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the GPU host)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def random_graph(P, fan, kind, seed, S=128):
    """A padded graph of P positions (the last eighth padding) and fan
    ``fan``, built as `pad_chain` builds its tables: a left-to-right
    chain with self loops, skips over one position and, for ``hmmnet``,
    irregular edges to and from random positions and explicit entry and
    final vectors (several entries and exits); a chain enters at 0 and
    leaves at its last position."""
    rng = np.random.default_rng(seed)
    Pr = max(P - P // 8, 1)
    fan_in = np.zeros(P, np.int64)
    fan_out = np.zeros(P, np.int64)
    edges = []
    for q in range(Pr):
        srcs = [q - 1] if q else []
        if rng.random() < 0.9:
            srcs.append(q)
        if q >= 2 and rng.random() < 0.3:
            srcs.append(q - 2)
        if kind == "hmmnet":
            srcs += [int(s) for s in rng.integers(0, Pr, fan - 2)]
        for s in dict.fromkeys(srcs):
            if fan_in[q] < fan and fan_out[s] < fan:
                edges.append((s, q, np.log(rng.uniform(0.05, 1.0)),
                              int(rng.integers(1, NUM_SLOTS))))
                fan_in[q] += 1
                fan_out[s] += 1
    in_src = np.tile(np.arange(P, dtype=np.int32)[:, None], (1, fan))
    out_tgt = in_src.copy()
    in_logp = np.full((P, fan), LOG_ZERO, np.float32)
    out_logp = np.full((P, fan), LOG_ZERO, np.float32)
    in_slot = np.zeros((P, fan), np.int32)
    ni = np.zeros(P, np.int64)
    no = np.zeros(P, np.int64)
    for s, q, w, slot in edges:
        in_src[q, ni[q]], in_logp[q, ni[q]], in_slot[q, ni[q]] = s, w, slot
        out_tgt[s, no[s]], out_logp[s, no[s]] = q, w
        ni[q] += 1
        no[s] += 1
    g = {"pdf": rng.integers(0, S, P).astype(np.int32), "in_src": in_src,
         "in_logp": in_logp, "in_slot": in_slot, "out_tgt": out_tgt,
         "out_logp": out_logp, "num_positions": np.int32(Pr),
         "final_logp": np.float32(np.log(0.5)), "final_slot": np.int32(0)}
    if kind == "hmmnet":
        for key, n in (("entry", 3), ("final", 4)):
            v = np.full(P, LOG_ZERO, np.float32)
            v[rng.choice(Pr, min(n, Pr), replace=False)] = np.log(
                rng.uniform(0.1, 1.0, min(n, Pr)))
            g[key] = v
    return g


def _batch(kind, B, T, P, fan, seed, dev, lengths=None, shift=False):
    """(obs [B, T, P], stacked graph, n_frames [B]) on ``dev``: lengths 1,
    T and in between; with ``shift`` the graphs shift-compiled."""
    rng = np.random.default_rng(seed)
    graphs = [random_graph(P, fan, kind, seed + b) for b in range(B)]
    if shift:
        graphs = [estep.shift_compile(g) for g in graphs]
    obs = rng.normal(-3.0, 1.5, (B, T, P)).astype(np.float32)
    if lengths is None:
        lengths = [(1, T, T // 2 + 3)[b % 3] if b < 3
                   else int(rng.integers(1, T + 1)) for b in range(B)]
    return (torch.as_tensor(obs, device=dev),
            estep.stack_graphs(graphs, dev),
            torch.as_tensor(lengths, dtype=torch.int64, device=dev))


def _kernel(obs, g, n, shift=False, backward=True):
    B, T, P = obs.shape
    return fb_cuda.chain_fb(obs, g, estep._entry(g, B, P, obs.device),
                            estep._final(g, P, obs.device), n, shift,
                            backward)


def _loops(obs, g, n, shift=False):
    loops = estep._shift_loops if shift else estep._gather_loops
    return loops(obs, g, estep._valid(n, obs.shape[1]))


def _total(alphas, g):
    P = alphas.shape[2]
    return estep.logsumexp(alphas[:, -1] + estep._final(g, P, alphas.device),
                           dim=1)


def _check_rows(got, want, name):
    live = want > LOG_ZERO / 2
    assert torch.equal(got > LOG_ZERO / 2, live), name
    for b in range(want.shape[0]):
        lb = live[b]
        if lb.any():
            scale = float(want[b][lb].abs().max()) + 1.0
            err = float((got[b][lb] - want[b][lb]).abs().max())
            assert err <= 1e-4 * scale, (name, b, err, scale)


# -- on the card --------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shift", [False, True], ids=["gather", "shift"])
@pytest.mark.parametrize("kind,fan", [("chain", 4), ("hmmnet", 8)])
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("P,T", [(64, 256), (704, 2048), (P_TABLES, 40),
                                 (P_ROWS, 40), (P_ROWS + 1, 40),
                                 (8192, 300)])
def test_kernel_matches_the_plain_loops(dev, kind, fan, B, P, T, shift):
    """Each form against its own plain loops: totals rel 1e-5, rows
    close, frozen rows repeat their last row (forward) or `final`
    (backward) exactly, as the plain loops'."""
    if B == 1:
        T = min(T, 256)
    obs, g, n = _batch(kind, B, T, P, fan, seed=P + B, dev=dev,
                       lengths=[T // 2 + 3] if B == 1 else None, shift=shift)
    alphas, betas = _kernel(obs, g, n, shift)
    pa, pb = _loops(obs, g, n, shift)
    torch.testing.assert_close(_total(alphas, g), _total(pa, g), rtol=1e-5,
                               atol=0.0)
    _check_rows(alphas, pa, "alphas")
    _check_rows(betas, pb, "betas")
    final = estep._final(g, P, dev)
    for b, nb in enumerate(n.tolist()):
        nb = min(max(nb, 1), T)
        assert torch.equal(alphas[b, nb:],
                           alphas[b, nb - 1].expand(T - nb, P))
        assert torch.equal(betas[b, nb - 1:],
                           final[b].expand(T - nb + 1, P))
        assert torch.equal(pa[b, nb:], pa[b, nb - 1].expand(T - nb, P))
        assert torch.equal(pb[b, nb - 1:], final[b].expand(T - nb + 1, P))


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [False, True], ids=["gather", "shift"])
@pytest.mark.parametrize("n", [1, 37, 64])
def test_kernel_lengths_at_the_edges(dev, n, shift):
    """B=1 at n_frames 1, in between and T_pad."""
    obs, g, nf = _batch("hmmnet", 1, 64, 96, 6, seed=n, dev=dev,
                        lengths=[n], shift=shift)
    alphas, betas = _kernel(obs, g, nf, shift)
    pa, pb = _loops(obs, g, nf, shift)
    torch.testing.assert_close(_total(alphas, g), _total(pa, g), rtol=1e-5,
                               atol=0.0)
    _check_rows(alphas, pa, "alphas")
    _check_rows(betas, pb, "betas")


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [False, True], ids=["gather", "shift"])
def test_kernel_is_deterministic_and_counts(dev, shift):
    """Two launches agree bit for bit; a forward-only launch gives the
    same alphas; each launch counts once and B x T frames."""
    obs, g, n = _batch("hmmnet", 8, 300, 704, 8, seed=3, dev=dev,
                       shift=shift)
    launches = profiling.counter("fb.launches")
    frames = profiling.counter("fb.frames")
    a1, b1 = _kernel(obs, g, n, shift)
    a2, b2 = _kernel(obs, g, n, shift)
    a3, b3 = _kernel(obs, g, n, shift, backward=False)
    assert torch.equal(a1, a2) and torch.equal(b1, b2)
    assert torch.equal(a1, a3) and b3 is None
    assert profiling.counter("fb.launches") - launches == 3
    assert profiling.counter("fb.frames") - frames == 3 * 8 * 300
    if not shift:
        ll = estep.masked_forward_log_likelihood(obs, g, n)
        torch.testing.assert_close(ll, _total(a1, g), rtol=0.0, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["chain", "hmmnet"])
@pytest.mark.parametrize("form", ["plain", "shift"])
def test_chain_stats_on_the_card_against_the_cpu(dev, kind, form):
    """`chain_stats` through the kernel against `chain_stats` on the
    CPU (the plain loops) on the same inputs, fetched by
    `train.driver.fetch`: log-likelihoods rel 1e-5, each statistic
    within 2e-5 of its scale (1e-4 for moment sums), feature counts
    identical, one launch."""
    from aaltoasr_tpu_torch.train.driver import fetch
    model = random_model(G=256, S=128, K=4, seed=1)
    B, T, P = 8, 400, 192
    graphs = [random_graph(P, 6, kind, 11 + b) for b in range(B)]
    if form == "shift":
        graphs = [estep.shift_compile(x) for x in graphs]
    rng = np.random.default_rng(5)
    feats = rng.normal(0, 2, (B, T, model.dim)).astype(np.float32)
    n = [1, T, T // 2 + 3, *rng.integers(1, T + 1, B - 3)]

    def stats(device):
        return fetch(estep.chain_stats(
            GmmScorer.from_model(model, device=device),
            torch.as_tensor(feats, device=device),
            estep.stack_graphs(graphs, device),
            torch.as_tensor(n, device=device), NUM_SLOTS))
    launches = profiling.counter("fb.launches")
    card = stats(dev)
    assert profiling.counter("fb.launches") - launches == 1
    cpu = stats("cpu")
    np.testing.assert_allclose(card["log_likelihood"], cpu["log_likelihood"],
                               rtol=1e-5)
    for k in card:
        want = cpu[k].astype(np.float64)
        scale = np.abs(want).max(initial=0.0)
        err = np.abs(card[k] - want).max(initial=0.0)
        tol = 0 if k == "feacount" else (1e-4 if "acc" in k else 2e-5)
        assert err <= tol * scale, (k, err, scale)


# -- dispatch, on the CPU -----------------------------------------------------

def test_plan_follows_shared_memory():
    assert fb_cuda.plan(704, 4, shift=True) == 1
    assert fb_cuda.plan(P_ROWS, 4, shift=True) == 1
    assert fb_cuda.plan(P_ROWS + 1, 4, shift=True) == 0
    assert fb_cuda.plan(704, 4) == 2
    assert fb_cuda.plan(P_TABLES, 4) == 2
    assert fb_cuda.plan(P_TABLES + 1, 4) == 1
    assert fb_cuda.plan(P_ROWS, 4) == 1
    assert fb_cuda.plan(P_ROWS + 1, 4) == 0
    assert fb_cuda.plan(8192, 4) == 0
    assert fb_cuda.smem_bytes(P_TABLES, 4, 2) <= SMEM_LIMIT
    assert fb_cuda.smem_bytes(P_ROWS, 4, 1) <= SMEM_LIMIT
    assert fb_cuda.smem_bytes(8192, 4, 0) == 0


@pytest.mark.parametrize("device,P,want", [
    ("cuda", 704, True), ("cuda", P_ROWS + 1, True), ("cuda", 8192, True),
    ("cpu", 704, False)])
def test_supports_needs_a_card(device, P, want):
    obs = types.SimpleNamespace(device=torch.device(device),
                                shape=(8, 2048, P))
    assert fb_cuda.supports(obs) is want


def _cpu_case(kind, seed=7):
    obs, g, n = _batch(kind, 3, 24, 40, 5, seed=seed, dev="cpu",
                       lengths=[24, 9, 1])
    gs = estep.stack_graphs([estep.shift_compile(random_graph(
        40, 5, kind, seed + b)) for b in range(3)], "cpu")
    return obs, g, gs, n


@pytest.mark.parametrize("kind", ["chain", "hmmnet"])
def test_cpu_runs_the_plain_loops_and_counts_nothing(kind, monkeypatch):
    """CPU tensors never reach the kernel: `chain_stats` in both forms
    runs, and `fb.launches` and `fb.frames` do not move."""
    def refuse(*a, **k):
        raise AssertionError("the kernel was called on the CPU")
    monkeypatch.setattr(fb_cuda, "chain_fb", refuse)
    counted = [profiling.counter(c) for c in ("fb.launches", "fb.frames")]
    obs, g, gs, n = _cpu_case(kind)
    model = random_model(G=64, S=128, D=3, K=2, seed=2)
    scorer = GmmScorer.from_model(model, device="cpu")
    feats = torch.as_tensor(np.random.default_rng(1).normal(
        0, 1, (3, 24, 3)).astype(np.float32))
    for graph in (g, gs):
        out = estep.chain_stats(scorer, feats, graph, n, NUM_SLOTS)
        assert torch.isfinite(out["log_likelihood"]).all()
    estep.masked_forward_log_likelihood(obs, g, n)
    assert [profiling.counter(c) for c in ("fb.launches", "fb.frames")] == (
        counted)


@pytest.mark.parametrize("kind", ["chain", "hmmnet"])
def test_every_recursion_goes_through_the_dispatch(kind, monkeypatch):
    """Where `supports` says yes, both FB forms and the forward-only
    likelihood take `chain_fb` (here a stand-in running the plain loops
    of the form it is asked for), each in its own form, backward only
    where they need it, and give the plain results."""
    obs, g, gs, n = _cpu_case(kind)
    want = {"gather": estep.masked_forward_backward(obs, g, n, NUM_SLOTS),
            "shift": estep.masked_forward_backward_shift(obs, gs, n,
                                                         NUM_SLOTS),
            "ll": estep.masked_forward_log_likelihood(obs, g, n)}
    calls = []

    def stand_in(obs_pos, graph, entry, final, n_frames, shift=False,
                 backward=True):
        calls.append((shift, backward))
        loops = estep._shift_loops if shift else estep._gather_loops
        return loops(obs_pos, dict(graph, entry=entry, final=final),
                     estep._valid(n_frames, obs_pos.shape[1]), backward)
    monkeypatch.setattr(fb_cuda, "supports", lambda *a: True)
    monkeypatch.setattr(fb_cuda, "chain_fb", stand_in)
    got = {"gather": estep.masked_forward_backward(obs, g, n, NUM_SLOTS),
           "shift": estep.masked_forward_backward_shift(obs, gs, n,
                                                        NUM_SLOTS),
           "ll": estep.masked_forward_log_likelihood(obs, g, n)}
    assert calls == [(False, True), (True, True), (False, False)]
    for a, b in zip(got["gather"], want["gather"]):
        assert torch.equal(a, b)
    assert torch.equal(got["ll"], want["ll"])
    for a, b in zip(got["shift"], want["shift"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["chain", "hmmnet"])
def test_shift_loops_match_the_gather_loops(kind):
    """The two forms' plain loops, two float32 orders of the same sums:
    rows close, the same reachable positions, the same totals."""
    obs, g, gs, n = _cpu_case(kind)
    valid = estep._valid(n, obs.shape[1])
    pa, pb = estep._gather_loops(obs, g, valid)
    sa, sb = estep._shift_loops(obs, gs, valid)
    _check_rows(sa, pa, "alphas")
    _check_rows(sb, pb, "betas")
    torch.testing.assert_close(_total(sa, gs), _total(pa, g), rtol=1e-5,
                               atol=0.0)
    fa, fb = estep._shift_loops(obs, gs, valid, backward=False)
    assert torch.equal(fa, sa) and fb is None


def test_irregular_edges_grouped_in_edge_order():
    """`fb_cuda._grouped`: each position's irregular edges in edge order,
    and each group's start, as the kernel walks them."""
    end = torch.tensor([[3, 0, 3, 1, 0, 3], [2, 2, 0, 0, 0, 2]])
    order, start = fb_cuda._grouped(end, 4)
    assert order.dtype == start.dtype == torch.int32
    for b in range(2):
        for p in range(4):
            got = order[b, start[b, p]:start[b, p + 1]].tolist()
            assert got == [e for e in range(6) if int(end[b, e]) == p]
    assert start[:, -1].tolist() == [6, 6]
