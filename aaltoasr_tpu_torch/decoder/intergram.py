"""Interpolated language models (`decoder/src/InterTreeGram.{hh,cc}`).

Linear interpolation in the probability domain over a union
vocabulary: ``P(w|h) = sum_i alpha_i P_i(w|h)`` with each member
resolving its own backoff (InterTreeGram::log_prob, InterTreeGram.cc;
the coefficients must sum to 1, InterTreeGram.cc:12-20).

The class quacks like ``ArpaLM`` (``order``, ``vocab``, ``word_index``,
``log_prob``), so lattice rescoring and perplexity use it unchanged.
Dynamic interpolation has no finite FSA form, so the on-device decoder
walk does not consume it; rescoring decodes' lattices with it covers
the reference's main use (morph_lattice/lattice rescoring pipelines).
"""

from __future__ import annotations

import math


class InterTreeGram:
    def __init__(self, models: list, coeffs: list):
        if len(models) != len(coeffs):
            raise ValueError(
                "There must be as many interpolation coeffs as LMs")
        if not 0.99 <= sum(coeffs) <= 1.01:
            raise ValueError(
                f"Interpolation coeffs must sum to 1 (!={sum(coeffs)})")
        if any(c < 0 for c in coeffs):
            raise ValueError("Interpolation coeffs must be in [0, 1]")
        self.models = list(models)
        self.coeffs = [float(c) for c in coeffs]
        self.order = max(m.order for m in models)

        # union vocabulary: first model's order, then new words
        self.vocab: list = []
        self.word_index: dict = {}
        for m in models:
            for w in m.vocab:
                if w not in self.word_index:
                    self.word_index[w] = len(self.vocab)
                    self.vocab.append(w)
        # union word id -> member-local id (-1 when absent)
        self._local = [
            [m.word_index.get(w, -1) for w in self.vocab]
            for m in models]

    def log_prob(self, ctx: tuple, word: int) -> float:
        """ln P with union-vocabulary word ids (safelogprob of the
        interpolated linear probability)."""
        p = 0.0
        for m, c, lmap in zip(self.models, self.coeffs, self._local):
            w = lmap[word]
            if w < 0:
                continue
            # context words unknown to this member simply never match
            # its n-grams, which is the natural backoff
            lctx = tuple(lmap[x] for x in ctx)
            lctx = lctx[-(m.order - 1):] if m.order > 1 else ()
            p += c * math.exp(m.log_prob(lctx, w))
        # safelogprob (def.hh:18-26): floor at prob 1e-60, i.e.
        # log10 -60 converted to the ln domain
        if p > 1e-60:
            return math.log(p)
        return -60.0 * math.log(10.0)
