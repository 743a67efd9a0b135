"""The dense step's node and beam kernels (`ops/dense_cuda.py`,
`csrc/dense_node.cu`) against the plain passes they replace, on the same
card, and their counters and tables on the CPU.

The kernels compute the plain passes' float32 ops in the same order, so
on one card they agree bit for bit: every state array, `fin` and the
rows' maxima after each frame, from the same state and the same
re-entries, at frame counts that leave rows frozen (or, without
``require_sentence_end``, running on past their ends), on the 30-word
cross-word task with durations, one without durations, an interpolated
LM, the morph task with ``<w>``, and the 1,000-word tree at B = 64 (one
row a block on an H100) and at B = 1,027 (five rows a block and a last
block of two on an H100's 132 SMs, which the test asserts: the tables
kept in registers across rows, a shared key a row, the beam pass's
double buffer).  `decode_batch` with the kernels gives what it
gives with the plain passes on the same card (words, scores, records),
and the CPU's words and scores (within float32 rounding: the card's and
the CPU's `log` may differ by an ulp).  Tests marked `cuda` need a CUDA
device and skip without one; on the GPU host run

    python -m pytest --noconftest tests/test_torch_dense_cuda.py

This file imports no jax.
"""

import functools

import numpy as np
import pytest
import torch

from aaltoasr_tpu_torch import synth
from aaltoasr_tpu_torch.decoder.ngram import InterNGramFsa, initial_code
from aaltoasr_tpu_torch.decoder.search import SearchConfig
from aaltoasr_tpu_torch.decoder.search_dense import (
    DenseBeamSearch, REENTRY_WIDTH, _shift_structure)
from aaltoasr_tpu_torch.decoder.toolbox import Toolbox
from aaltoasr_tpu_torch.ops import dense_cuda
from aaltoasr_tpu_torch.ops.logsemiring import LOG_ZERO
from aaltoasr_tpu_torch.utils import profiling

from portbench.traffic import files
from portbench.traffic.morph import morph_plan, morph_task

NAMES = ("total", "lms", "lm", "dur", "rec", "bo", "alive")
FIN = ("rec", "total", "am", "lms")
KINDS = ("durations", "no_durations", "inter", "morph", "xw1k", "xw1k_rows")
# (B, T) of the frame-by-frame test; 4 x 250 for the rest
SHAPES = {"xw1k": (64, 40), "xw1k_rows": (1027, 64)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the GPU host)")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _xw(num_words=30, durations=True):
    return synth.synth_task(num_words=num_words, order=3, triphone=True,
                            durations=durations)


def _morph(tmp):
    """The morph test task (48 morphs, order 6, durations) on the port's
    Toolbox, configured as `recognize` configures a morph LM."""
    task = morph_task(num_morphs=48, num_phones=6, seed=3, order=6,
                      ngram_counts={2: 400, 3: 300, 4: 200, 5: 120, 6: 60})
    S = task["num_states"]
    paths = files.write_model(
        str(tmp / "am"), task["phones"], task["transitions"],
        np.zeros((S, 1)), np.ones((S, 1)), np.arange(S)[:, None],
        np.ones((S, 1)), task["durations"])
    (tmp / "lex.txt").write_text("\n".join(task["lex_lines"]) + "\n")
    files.write_arpa(str(tmp / "lm.arpa"), task["vocab"], task["ngrams"])
    t = Toolbox(paths["ph"], paths["dur"], device="cpu")
    t.set_silence_is_word(True)
    t.set_word_boundary("<w>")
    t.set_optional_short_silence(True)
    t.lex_read(str(tmp / "lex.txt"))
    t.ngram_read(str(tmp / "lm.arpa"))
    return task, t


def build(kind, require_end, device, tmp, B=4, T=250):
    """(search on ``device``, obs [B, T, S] numpy, frame counts [B]); the
    counts leave a row frozen from the first frame and two ending early."""
    if kind == "morph":
        task, tb = _morph(tmp)
        cfg = SearchConfig(beam=280.0, lm_scale=30.0, duration_scale=3.0,
                           num_records=32, word_boundary="<w>",
                           require_sentence_end=require_end)
        tree, lm, model = tb.tree, tb.lm, tb.model
        rng = np.random.default_rng(11)
        S = task["num_states"]
        obs = np.full((B, T, S), -100.0, np.float32)
        for b in range(B):
            states, _ = morph_plan(task, T, rng)
            lp = np.full((T, S), -8.0, np.float32)
            lp[np.arange(T), states] = -0.35
            obs[b] = lp + 0.5 * rng.standard_normal((T, S)).astype(np.float32)
    else:
        task = _xw(1000 if kind.startswith("xw1k") else 30,
                   kind != "no_durations")
        cfg = SearchConfig(beam=280.0, lm_scale=30.0, duration_scale=3.0,
                           num_records=32, require_sentence_end=require_end)
        tree, lm, model = task.tree, task.fsa, task.model
        if kind == "inter":
            other = synth.synth_task(num_words=30, order=2, seed=5).arpa
            lm = InterNGramFsa.from_arpas([task.arpa, other], [0.6, 0.4])
        plan, _ = synth.synth_obs(model, task.info, B, T)
        obs = synth.planted_obs(plan, model.num_states,
                                torch.Generator().manual_seed(3)).numpy()
    n = np.resize([T, T - 31, 1, T - 58], B)
    return DenseBeamSearch(tree, lm, model, cfg, device=device), obs, n


def bits(x):
    if x.dtype == torch.float32:
        return x.contiguous().view(torch.int32)
    return x.to(torch.uint8) if x.dtype == torch.bool else x


def assert_bits(got, want, names, what):
    for g, w, name in zip(got, want, names):
        diff = bits(g) != bits(w)
        assert not bool(diff.any()), (
            f"{what}: {name} differs at {int(diff.sum())} of {diff.numel()}")


@pytest.mark.cuda
@pytest.mark.parametrize("require_end", [False, True],
                         ids=["snap", "freeze"])
@pytest.mark.parametrize("kind", KINDS)
def test_passes_match_the_plain_passes(dev, kind, require_end, tmp_path):
    """Frame by frame from one state: the node pass + the beam pass
    against `_node_pass_plain` + `_beam_pass_plain` on the card."""
    B, T = SHAPES.get(kind, (4, 250))
    search, obs, n = build(kind, require_end, dev, tmp_path, B, T)
    cfg = search.config
    rows = dense_cuda.plan(B, search.tree.num_nodes)[2]
    if kind == "xw1k_rows":
        # several rows a block, the last block short
        assert rows > 1 and B % rows != 0, rows
    obs = torch.as_tensor(obs, device=dev)
    n = torch.as_tensor(n, device=dev)
    state = search._initial_state(obs, initial_code(search.lm, "<s>"))
    fin = search._fin_of(state)
    state = dense_cuda.padded(state)
    spare = dense_cuda.padded(state)
    scr = dense_cuda.Scratch(B, dev)
    pdf = search.t["pdf"]
    moved = 0
    for i in range(T - 1):
        v = (i + 1) < n
        cands, _ = search._words(state, i, False)
        reentry = search._reentry(*cands)
        want, rowmax = search._node_pass_plain(state, obs[:, i + 1][:, pdf],
                                               reentry, v)
        want, want_fin = search._beam_pass_plain(want, rowmax, v, fin)
        got = dense_cuda.node_pass(search._kt, state, spare, obs, i + 1,
                                   reentry, n, require_end, scr)
        got, got_fin = dense_cuda.beam_pass(
            got, n, i + 1, require_end, cfg.beam, cfg.lm_scale_eff,
            tuple(f.clone() for f in fin), scr)
        torch.cuda.synchronize()
        what = f"{kind} frame {i + 1}"
        assert_bits(got, want, NAMES, what)
        assert_bits(got_fin, want_fin, FIN, what)
        assert_bits([scr.rowmax], [rowmax], ["row max"], what)
        moved += int((got[4] != state[4]).sum())
        spare, state, fin = state, got, got_fin
    # the scratch is clear for the next frame, and records moved
    assert not bool(scr.acc.any() or scr.arg.any() or scr.done.any())
    assert moved > 0


@pytest.mark.cuda
@pytest.mark.parametrize("require_end", [False, True],
                         ids=["snap", "freeze"])
@pytest.mark.parametrize("kind", KINDS[:4])
def test_decode_batch_kernels_against_plain_and_cpu(dev, kind, require_end,
                                                    tmp_path):
    """`decode_batch` on the card: the kernels (B x (T-1) node-pass rows)
    against the plain passes on the same card, bit for bit in words,
    scores and records; and the CPU's words and scores."""
    search, obs, n = build(kind, require_end, dev, tmp_path)
    B, T = obs.shape[:2]
    before = profiling.counter("dense.node_pass.rows")
    launches = [profiling.counter(f"dense.{k}.launches")
                for k in ("node", "beam")]
    got = search.decode_batch(obs, n)
    assert profiling.counter("dense.node_pass.rows") - before == B * (T - 1)
    for k, was in zip(("node", "beam"), launches):
        assert profiling.counter(f"dense.{k}.launches") - was == T - 1, k
    search._kt = None
    plain = search.decode_batch(obs, n)
    cpu = build(kind, require_end, "cpu", tmp_path)[0].decode_batch(obs, n)
    assert any(r.words for r in cpu)
    for g, p, c in zip(got, plain, cpu):
        assert g.words == p.words == c.words
        for f in ("log_prob", "final_am", "final_lms", "final_ptr",
                  "final_word"):
            assert getattr(g, f) == getattr(p, f), f
        for f in ("rec_words", "rec_prevs", "rec_ams", "rec_lmss"):
            np.testing.assert_array_equal(getattr(g, f), getattr(p, f))
        assert g.log_prob == pytest.approx(c.log_prob, rel=1e-5)


# -- on the CPU ---------------------------------------------------------------

def test_cpu_counts_rows_and_runs_no_kernel():
    """`dense.rows` counts B a frame on any device; the CPU runs the plain
    passes, so `dense.node_pass.rows` and the launch counters stay."""
    search, obs, n = build("durations", True, "cpu", None, B=4, T=30)
    rows = profiling.counter("dense.rows")
    kern = [profiling.counter(k) for k in (
        "dense.node_pass.rows", "dense.node.launches", "dense.beam.launches")]
    search.decode_batch(obs, n, lattice=False)
    assert search._kt is None
    assert profiling.counter("dense.rows") - rows == 4 * 29
    assert [profiling.counter(k) for k in (
        "dense.node_pass.rows", "dense.node.launches",
        "dense.beam.launches")] == kern


@pytest.mark.parametrize("kind", ["durations", "no_durations"])
def test_kernel_tables(kind):
    """The kernels' tables: rows padded to a multiple of 4 with no
    irregular and no entry row; int32 indices; a target scans its arcs
    and one padding entry, all of whose padding entries are equal; the
    duration bonus cannot move a dead LOG_ZERO source."""
    search = build(kind, True, "cpu", None)[0]
    t = search.t
    grp_lp = _shift_structure(search.tree)[2]
    kt = dense_cuda.tables(t, grp_lp, search.config.max_dur,
                           search._has_durations, search._NR)
    N, ld = kt["N"], kt["ld"]
    assert ld % dense_cuda.VEC == 0 and N <= ld < N + dense_cuda.VEC
    assert kt["has_dur"] == (kind == "durations") and kt["dead_skip"]
    for k in ("pdf", "grp_inv", "entry_inv", "grp_src", "grp_cnt"):
        assert kt[k].dtype == torch.int32, k
    assert torch.equal(kt["grp_inv"][:N].long(), t["grp_inv"])
    assert bool((kt["grp_inv"][N:] == kt["Mi"]).all())
    assert bool((kt["entry_inv"][N:] == kt["M"]).all())
    assert torch.equal(kt["dur4"][:N, 1], t["dur_lncoef"])
    n_arcs = (grp_lp > LOG_ZERO / 2).sum(axis=1)
    assert (kt["grp_cnt"].numpy() == np.minimum(kt["F"], n_arcs + 1)).all()
    for m in np.nonzero(n_arcs < kt["F"])[0][:50]:
        pad_src = t["grp_src"][m, n_arcs[m]:]
        pad_ts = t["ts_grp"][m, n_arcs[m]:]
        assert bool((pad_src == 0).all()) and bool((pad_ts == pad_ts[0]).all())
    lz = torch.tensor(LOG_ZERO, dtype=torch.float32)
    assert lz + torch.tensor(dense_cuda.DEAD_BONUS, dtype=torch.float32) == lz
    assert lz - torch.tensor(dense_cuda.DEAD_BONUS, dtype=torch.float32) == lz


def test_padded_state_views():
    """`padded` copies [B, N] arrays into [B, ld] storage as views."""
    x = torch.arange(2 * 7, dtype=torch.float32).reshape(2, 7)
    y = torch.arange(2 * 7).reshape(2, 7)
    px, py = dense_cuda.padded((x, y))
    assert px.stride() == (8, 1) and py.stride() == (8, 1)
    assert torch.equal(px, x) and torch.equal(py, y)
    assert REENTRY_WIDTH == dense_cuda.C
