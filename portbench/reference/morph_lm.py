"""The plain reference of a morph LM's score of a unit sequence.

The log-probability, in float64 and natural log, of the units a
recognizer committed, under an n-gram table ``{order: {id tuple: (ln
p, ln backoff)}}`` by the backoff recursion: ln P(w | h) is the n-gram
h·w's if the table holds it, else backoff(h) + ln P(w | h less its
first unit), with backoff(h) 0 where h is not a gram and h cut to the
last ``order - 1`` units.  Morph mode's rules (AaltoASR
`decoder/src/TokenPassSearch.cc:869-919`, `pyrectool/rectool.py:529-564`):

- the history starts at the sentence start ``<s>``; the short silence
  that usually opens an utterance commits the boundary, giving
  ``<s> <w>``;
- the boundary ``<w>`` right after ``<w>`` is impossible (-inf);
- a sentence end ``</s>`` is scored, then the history restarts at
  ``<s> <w>``; a recognizer prints that restart as ``</s> <s> <w>``,
  and the ``<s> <w>`` it adds are not scored;
- with ``sentence_end`` the final ``</s>`` is scored after the last unit;
- each unit also adds what the recognizer adds per word: its
  pronunciation's log-prob and the insertion penalty (``pron`` and
  ``insertion``, both in the LM's natural-log units).

Written from the rules above in plain Python and PyTorch, independent
of the program; it imports neither the program nor JAX.
"""

from __future__ import annotations

import math

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NEG_INF = float("-inf")


def log_prob(ngrams: dict, order: int, hist: tuple, w: int) -> float:
    """ln P(w | hist) by the backoff recursion, -inf for a word the
    table lacks."""
    h = tuple(hist[-(order - 1):]) if order > 1 else ()
    backoff = 0.0
    while True:
        hit = ngrams.get(len(h) + 1, {}).get(h + (w,))
        if hit is not None:
            return backoff + hit[0]
        if not h:
            return NEG_INF
        backoff += ngrams[len(h)].get(h, (0.0, 0.0))[1]
        h = h[1:]


def score(ngrams: dict, vocab: list, units: list, order: int,
          boundary: str = "<w>", start: str = "<s>", end: str = "</s>",
          sentence_end: bool = True, pron: dict | None = None,
          insertion: float = 0.0) -> float:
    """ln score of ``units`` (names, as a recognizer prints them) under
    morph mode's rules; ``order`` may be below the table's, which caps
    the walk there."""
    index = {v: i for i, v in enumerate(vocab)}
    pron = pron or {}
    s, wb, e = index[start], index[boundary], index[end]
    hist: tuple = (s,)
    total = 0.0
    skip = 0
    for i, name in enumerate(units):
        if skip:
            skip -= 1
            continue
        w = index[name]
        if w == wb and hist[-1] == wb:
            return NEG_INF
        total += log_prob(ngrams, order, hist, w) + pron.get(name, 0.0) \
            + insertion
        if w == e:
            hist = (s, wb)
            skip = 2 if units[i + 1:i + 3] == [start, boundary] else 0
        else:
            hist = hist + (w,)
    if sentence_end:
        total += log_prob(ngrams, order, hist, e)
    return total


def relative_gap(got: float, want: float) -> float:
    """|got - want| / |want|; inf where either is not finite."""
    if not (math.isfinite(got) and math.isfinite(want)) or want == 0.0:
        return math.inf
    return abs(got - want) / abs(want)
