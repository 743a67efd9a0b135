"""Planted state plans: what each utterance says, frame by frame.

A frozen, extended copy of the program's `synth_obs`: word sequences
follow the LM's own bigrams, each phone's tied state comes from its
cross-word context, and stay lengths from the model's gamma durations.
Utterances hold whole words only, so the planted words are the true
transcript.  Lengths come from one fixed set per workload
(`length_set`), which every seed permutes: each seed does the same work
in another order.  A workload whose unit of work (a batch, a shard) is
``count`` utterances gives each of its ``units`` units its own
permutation of the set, so every unit does the same work.
"""

from __future__ import annotations

import numpy as np

from portbench.traffic.task import context_label


def length_set(count: int, median_s: float, sigma: float, lo_s: float,
               hi_s: float, frame_rate: float, seed: int) -> np.ndarray:
    """[count] utterance lengths in frames: log-normal seconds with this
    median and sigma, clipped to [lo_s, hi_s]."""
    rng = np.random.default_rng(seed)
    s = np.clip(median_s * np.exp(sigma * rng.standard_normal(count)),
                lo_s, hi_s)
    return np.round(s * frame_rate).astype(np.int64)


def run_lengths(lengths: dict, frame_rate: float, seed: int) -> np.ndarray:
    """The workload's fixed length set (``lengths``: count, median_s,
    sigma, lo_s, hi_s, set_seed and optionally units, default 1) in the
    orders of run ``seed``: [units * count], one permutation a unit."""
    base = length_set(lengths["count"], lengths["median_s"],
                      lengths["sigma"], lengths["lo_s"], lengths["hi_s"],
                      frame_rate, lengths["set_seed"])
    rng = np.random.default_rng(seed)
    return np.concatenate([base[rng.permutation(len(base))]
                           for _ in range(lengths.get("units", 1))])


def _gamma_frames(rng, a: float, b: float) -> int:
    return int(np.clip(round(rng.gamma(a, b)), 1, 12))


def word_plan(task: dict, T: int, rng) -> tuple[np.ndarray, list]:
    """One utterance of exactly ``T`` frames of LM-plausible whole words
    (as the program's `synth_obs` plans them, without silences); the
    last word's states share the frames left over.  Returns ([T] int32
    tied state per frame, the planted word indices)."""
    prons, follow, dur = task["prons"], task["follow"], task["durations"]
    labels = task["phones"]

    def next_word(prev):
        nx = follow.get(prev)
        if nx:
            return int(nx[int(rng.integers(len(nx)))])
        return int(rng.integers(len(prons)))

    def states_of(w, prev_last, right_word):
        p = prons[w]
        seg = []
        for j, c in enumerate(p):
            left = p[j - 1] if j > 0 else prev_last
            right = p[j + 1] if j + 1 < len(p) else right_word
            seg += labels[context_label(labels, left, c, right)]
        return seg

    words: list = []
    stays: list = []                  # (state, frames) of the plan
    used = 0
    prev_last = "_"
    w = next_word(-1)
    w_next = next_word(w)
    for _ in range(64 * T):
        seg = states_of(w, prev_last, prons[w_next][0])
        d = [_gamma_frames(rng, *dur[s]) for s in seg]
        if used + sum(d) <= T:
            stays += list(zip(seg, d))
            used += sum(d)
            words.append(w)
            prev_last = prons[w][-1]
            w, w_next = w_next, next_word(w_next)
        elif words or len(seg) <= T:
            break
        else:
            w, w_next = w_next, next_word(w_next)
    if not words:
        seg = states_of(w, prev_last, prons[w_next][0])
        stays = [(s, 1) for s in seg]
        used = len(seg)
        words.append(w)
    # the frames left over go to the last word's states, evenly
    n_last = len(states_of(words[-1], "_", "_"))
    rest = T - used
    tail = stays[-n_last:]
    extra = np.full(n_last, rest // n_last)
    extra[:rest % n_last] += 1
    stays[-n_last:] = [(s, d + int(e)) for (s, d), e in zip(tail, extra)]
    plan = np.concatenate([np.full(d, s, np.int32) for s, d in stays])
    return plan, words


def phone_frames(task: dict) -> float:
    """Mean frames of a phone: its states' geometric stays under their
    self-loop probabilities, averaged over the inventory."""
    trans = task["transitions"]
    return float(np.mean([sum(1.0 / (1.0 - dict(trans[s])[0])
                              for s in states)
                          for states in task["phones"].values()]))


def phone_plan(task: dict, T: int, rng, rate: float | None = None) -> tuple:
    """One training utterance of exactly ``T`` frames: round(T / mean
    phone frames) uniformly drawn phones (so the chain's length, as the
    utterance's, is the same in every seed), each state's stay drawn
    geometric under its self-loop probability and all stays then scaled
    to fill ``T``, each state at least one frame.  Returns ([T] int32
    states, phone labels)."""
    names = list(task["phones"])
    trans = task["transitions"]
    rate = rate or phone_frames(task)
    width = max(len(v) for v in task["phones"].values())
    n = int(min(max(round(T / rate), 1), T // width))
    labels = [names[int(i)] for i in rng.integers(len(names), size=n)]
    states = [s for lbl in labels for s in task["phones"][lbl]]
    stays = np.asarray([rng.geometric(1.0 - dict(trans[s])[0])
                        for s in states], np.float64)
    share = stays / stays.sum() * (T - len(states))
    d = 1 + np.floor(share).astype(np.int64)
    rest = T - int(d.sum())
    d[np.argsort(-(share - np.floor(share)), kind="stable")[:rest]] += 1
    plan = np.repeat(np.asarray(states, np.int32), d)
    return plan, labels


def plans(task: dict, lengths: np.ndarray, seed: int, kind: str) -> tuple:
    """Plans of every utterance of a run: (list of [T] plans, list of
    transcripts), drawn from ``seed``."""
    rng = np.random.default_rng([seed, 1])
    if kind == "words":
        out = [word_plan(task, int(T), rng) for T in lengths]
    else:
        rate = phone_frames(task)
        out = [phone_plan(task, int(T), rng, rate) for T in lengths]
    return [p for p, _ in out], [w for _, w in out]
