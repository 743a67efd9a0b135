"""The dense engine in morph mode (`<w>` word boundaries, an order-6
morph LM): the port's `DenseBeamSearch` against the JAX package's on
the same files, against the port's exact engine, and its ``final_lms``
against the plain reference of the benchmark's morph cell
(`portbench/reference/morph_lm.py`), which is itself held to
hand-computed cases here.

The task is the benchmark's morph generator at a small size (48 morphs
over 6 phones, n-grams of orders 2-6); the utterances are its planted
walks of the LM, as noisy state log-probs.
"""

import math

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX package's engines run on the CPU)

from aaltoasr_tpu.decoder.search_dense import DenseBeamSearch as JDense
from aaltoasr_tpu.decoder.toolbox import Toolbox as JToolbox

from aaltoasr_tpu_torch.decoder.search_dense import DenseBeamSearch
from aaltoasr_tpu_torch.decoder.toolbox import Toolbox
from aaltoasr_tpu_torch.utils import profiling

from portbench.reference import morph_lm
from portbench.traffic import files
from portbench.traffic.morph import morph_plan, morph_task

torch.set_num_threads(1)

COUNTS = {2: 400, 3: 300, 4: 200, 5: 120, 6: 60}
LENGTHS = (260, 210, 170, 240)
# the existing dense parity tests' tolerance on scores
REL = 1e-4


def write_task(tmp, durations):
    task = morph_task(num_morphs=48, num_phones=6, seed=3, order=6,
                      ngram_counts=COUNTS)
    S = task["num_states"]
    paths = files.write_model(
        str(tmp / "am"), task["phones"], task["transitions"],
        np.zeros((S, 1)), np.ones((S, 1)), np.arange(S)[:, None],
        np.ones((S, 1)), task["durations"] if durations else None)
    (tmp / "lex.txt").write_text("\n".join(task["lex_lines"]) + "\n")
    files.write_arpa(str(tmp / "lm.arpa"), task["vocab"], task["ngrams"])
    return task, paths


def log_probs(task, seed):
    """[B, T, S] noisy state log-probs of the task's planted walks, their
    frame counts and the planted units."""
    rng = np.random.default_rng(seed)
    S = task["num_states"]
    obs = np.full((len(LENGTHS), max(LENGTHS), S), -100.0, np.float32)
    units = []
    for b, T in enumerate(LENGTHS):
        states, said = morph_plan(task, T, rng)
        lp = np.full((T, S), -8.0, np.float32)
        lp[np.arange(T), states] = -0.35
        lp += 0.5 * rng.standard_normal((T, S)).astype(np.float32)
        obs[b, :T] = lp - np.log(np.exp(lp).sum(axis=1, keepdims=True))
        units.append([task["words"][w] for w in said])
    return obs, np.asarray(LENGTHS), units


def configure(t, tmp, durations):
    """`recognize`'s calls for a morph LM, on either package's Toolbox."""
    t.set_silence_is_word(True)
    t.set_word_boundary("<w>")
    t.set_optional_short_silence(True)
    t.set_require_sentence_end(True)
    t.lex_read(str(tmp / "lex.txt"))
    t.ngram_read(str(tmp / "lm.arpa"))
    t.set_global_beam(280.0)
    t.set_token_limit(1024)
    t.set_lm_scale(30.0)
    t.set_duration_scale(3.0 if durations else 0.0)
    t.config.num_records = 32
    return t


@pytest.fixture(scope="module", params=[False, True],
                ids=["no_durations", "durations"])
def decoded(request, tmp_path_factory):
    durations = request.param
    tmp = tmp_path_factory.mktemp("morph")
    task, paths = write_task(tmp, durations)
    args = (paths["ph"], paths.get("dur", ""))
    port = configure(Toolbox(*args, device="cpu"), tmp, durations)
    ref = configure(JToolbox(*args), tmp, durations)
    obs, n, units = log_probs(task, 11)
    dense = DenseBeamSearch(port.tree, port.lm, port.model, port.config,
                            device="cpu")
    got = dense.decode_batch(obs, n, lattice=False)
    want = JDense(ref.tree, ref.lm, ref.model, ref.config).decode_batch(
        obs, n, lattice=False)
    exact = [port.decode(obs[b, :n[b]], lattice=False)
             for b in range(len(n))]
    return task, port, got, want, exact, units


def test_the_tree_and_lm_are_morph_mode(decoded):
    task, port, got, *_ = decoded
    assert port.lm.order == 6
    assert port.config.word_boundary == "<w>"
    assert "<w>" in port.tree.vocab and "</s>" in port.tree.vocab
    assert any("<w>" in r.words for r in got)


def test_dense_matches_the_jax_dense_engine(decoded):
    _, _, got, want, *_ = decoded
    for g, w in zip(got, want):
        assert g.words == w.words
        assert g.final_word == w.final_word
        for f in ("log_prob", "final_am", "final_lms"):
            assert getattr(g, f) == pytest.approx(getattr(w, f), rel=REL), f


def morphs(words):
    """The morph sequence: boundary and sentence units left out."""
    return [w for w in words if w not in ("<s>", "</s>", "<w>")]


def test_dense_agrees_with_the_exact_engine(decoded):
    """The dense engine keeps one hypothesis a node, the exact one 1,024
    tokens: their morph sequences agree on all but one utterance
    (tests/test_golden_morph.py's rule; where a silence reads as `<w>`
    or as `</s> <s> <w>` may differ)."""
    _, _, got, _, exact, _ = decoded
    same = sum(morphs(g.words) == morphs(e.words) for g, e in zip(got, exact))
    assert same >= len(got) - 1, [(g.words, e.words)
                                  for g, e in zip(got, exact)]


def test_dense_finds_the_planted_units(decoded):
    """Joined into words, the 1-best says the planted text (the short
    silence may also read as `</s> <s> <w>`, which joins the same) in all
    but one utterance, whose last word the final frames may cut."""
    from aaltoasr_tpu_torch.cli.recognize import morph_text
    _, _, got, _, _, units = decoded
    same = sum(morph_text(g.words) == morph_text(u)
               for g, u in zip(got, units))
    assert same >= len(got) - 1


def test_final_lms_matches_the_plain_reference(decoded):
    """float32 sums of ~20 float32 log-probs against float64: within
    1e-5 of the score; the same capped at order 3 is far off."""
    task, _, got, *_ = decoded
    capped = []
    for g in got:
        want = morph_lm.score(task["ngrams"], task["vocab"], g.words, 6)
        assert morph_lm.relative_gap(g.final_lms, want) < 1e-5
        capped.append(morph_lm.relative_gap(
            g.final_lms, morph_lm.score(task["ngrams"], task["vocab"],
                                        g.words, 3)))
    assert max(capped) > 1e-3


def test_the_lm_walk_span_and_state_counter(decoded):
    """`dense.lmwalk` records inside `dense.words` under a profile;
    `dense.state_bytes` counts 2 x B x N x 37 bytes a frame."""
    task, port, *_ = decoded
    obs, n, _ = log_probs(task, 12)
    dense = DenseBeamSearch(port.tree, port.lm, port.model, port.config,
                            device="cpu")
    before = profiling.counter("dense.state_bytes")
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        since = len(profiling.spans())
        dense.decode_batch(obs[:2, :40], [40, 40], lattice=False)
    recs = profiling.spans(since)
    names = [r.name for r in recs]
    assert names.count("dense.lmwalk") == names.count("dense.words") == 39
    for r in recs:
        if r.name == "dense.lmwalk":
            assert recs[r.parent - since].name == "dense.words"
    N = port.tree.num_nodes
    assert (profiling.counter("dense.state_bytes") - before
            == 39 * 2 * 2 * N * (4 + 4 + 8 + 8 + 8 + 4 + 1))


# -- the reference itself ---------------------------------------------------

VOCAB = ["<s>", "</s>", "a", "b", "<w>"]
S_, E_, A, B_, W = range(5)
LN = {  # (ln p, ln backoff), hand-written, order 6
    1: {(S_,): (-9.0, -0.5), (E_,): (-2.0, 0.0), (A,): (-1.5, -0.25),
        (B_,): (-1.75, -0.125), (W,): (-1.0, -0.0625)},
    2: {(S_, W): (-0.1, -0.3), (W, A): (-0.7, -0.2), (A, B_): (-0.6, -0.4),
        (B_, W): (-0.5, -0.1), (W, E_): (-0.9, 0.0), (B_, A): (-0.8, -0.15)},
    3: {(S_, W, A): (-0.3, -0.05), (W, A, B_): (-0.4, -0.6),
        (A, B_, W): (-0.2, -0.7)},
    4: {(S_, W, A, B_): (-0.35, -0.45), (W, A, B_, W): (-0.15, -0.35)},
    5: {(S_, W, A, B_, W): (-0.11, -0.22)},
    6: {(S_, W, A, B_, W, A): (-0.01, 0.0)},
}


def lp(*names, order=6):
    ids = [VOCAB.index(x) for x in names]
    return morph_lm.log_prob(LN, order, tuple(ids[:-1]), ids[-1])


def test_reference_hits_the_longest_gram():
    assert lp("<s>", "<w>", "a", "b", "<w>", "a") == -0.01
    assert lp("<s>", "<w>", "a", "b", "<w>") == -0.11
    assert lp("<s>", "<w>", "a") == -0.3


def test_reference_backs_off_through_every_context():
    # no 6-gram ends b after <s> <w> a b <w>: each shorter history adds
    # its backoff weight down to the unigram
    got = lp("<s>", "<w>", "a", "b", "<w>", "b")
    assert got == pytest.approx(-0.22 - 0.35 - 0.7 - 0.1 - 0.0625 - 1.75)
    # a history that is not a gram backs off for free: (a a) is none
    assert lp("a", "a", "b") == pytest.approx(-0.6)
    # capped at order 3 the 6-gram is out of reach: bo(b <w>) + P(a | <w>)
    assert lp("<s>", "<w>", "a", "b", "<w>", "a", order=3) == \
        pytest.approx(-0.1 - 0.7)


def test_reference_score_rules():
    ng = LN
    # <s> opens the history; the final </s> is scored
    want = (lp("<s>", "<w>") + lp("<s>", "<w>", "a") + lp("<s>", "<w>", "a", "b")
            + lp("<s>", "<w>", "a", "b", "<w>")
            + lp("<s>", "<w>", "a", "b", "<w>", "</s>"))
    assert morph_lm.score(ng, VOCAB, ["<w>", "a", "b", "<w>"], 6) == \
        pytest.approx(want)
    # <w> right after <w> is impossible
    assert morph_lm.score(ng, VOCAB, ["<w>", "a", "<w>", "<w>"], 6) == \
        -math.inf
    assert morph_lm.score(ng, VOCAB, ["<w>", "<w>"], 6) == -math.inf
    # </s> restarts at <s> <w>; the printed <s> <w> after it are not scored
    reset = (lp("<s>", "a") + lp("<s>", "a", "</s>") + lp("<s>", "<w>", "a")
             + lp("<s>", "<w>", "a", "</s>"))
    assert morph_lm.score(ng, VOCAB, ["a", "</s>", "<s>", "<w>", "a"],
                          6) == pytest.approx(reset)
    assert morph_lm.score(ng, VOCAB, ["a", "</s>", "a"], 6) == \
        pytest.approx(reset)
    # after a reset a <w> is a second boundary
    assert morph_lm.score(ng, VOCAB, ["a", "</s>", "<s>", "<w>", "<w>"],
                          6) == -math.inf
    # no final </s> without sentence_end; pronunciations and the
    # insertion penalty add per unit
    plain = morph_lm.score(ng, VOCAB, ["<w>", "a"], 6, sentence_end=False)
    assert plain == pytest.approx(lp("<s>", "<w>") + lp("<s>", "<w>", "a"))
    assert morph_lm.score(ng, VOCAB, ["<w>", "a"], 6, sentence_end=False,
                          pron={"a": -0.5}, insertion=-1.0) == \
        pytest.approx(plain - 0.5 - 2.0)


def test_reference_relative_gap():
    assert morph_lm.relative_gap(-99.0, -100.0) == pytest.approx(0.01)
    assert morph_lm.relative_gap(-1.0, -math.inf) == math.inf
    assert morph_lm.relative_gap(-math.inf, -1.0) == math.inf
