"""Morph segmentation of words with a morph LM
(`decoder/src/morpheus/Morpheus.{hh,cc}`).

Finnish subword LMs operate on morphs; Morpheus splits a word into the
morph sequence maximizing the LM score (Viterbi over split points with
LM-context states — the reference walks its fsalm over a Trie of morph
candidates; here the candidate set is the LM vocabulary itself and
contexts are n-gram histories).
"""

from __future__ import annotations

from functools import lru_cache

from aaltoasr_tpu_torch.formats.arpa import ArpaLM


class Morpheus:
    def __init__(self, lm: ArpaLM, word_boundary: str = "<w>"):
        self.lm = lm
        self.word_boundary = word_boundary
        # morph string set (skip specials)
        self.morphs = {w for w in lm.vocab
                       if w not in ("<s>", "</s>", word_boundary)}
        self.max_len = max((len(m) for m in self.morphs), default=1)

    def segment(self, word: str, context: tuple = ()) -> list:
        """Best morph split of ``word``; raises ValueError if the word
        cannot be covered by LM morphs."""
        n = len(word)
        order = self.lm.order
        # DP over (position, context); states kept per position
        # best[(pos, ctx)] = (score, prev_state, morph)
        start = (0, tuple(context)[-(order - 1):] if order > 1 else ())
        best = {start: (0.0, None, None)}
        frontier = {start}
        for pos in range(n):
            states = [s for s in frontier if s[0] == pos]
            for state in states:
                _, ctx = state
                score = best[state][0]
                for end in range(pos + 1,
                                 min(pos + self.max_len, n) + 1):
                    piece = word[pos:end]
                    if piece not in self.morphs:
                        continue
                    wid = self.lm.word_index[piece]
                    lp = self.lm.log_prob(ctx, wid)
                    if lp == float("-inf"):
                        continue
                    new_ctx = ((ctx + (wid,))[-(order - 1):]
                               if order > 1 else ())
                    key = (end, new_ctx)
                    cand = (score + lp, state, piece)
                    if key not in best or cand[0] > best[key][0]:
                        best[key] = cand
                        frontier.add(key)
        finals = [s for s in best if s[0] == n]
        if not finals:
            raise ValueError(
                f"Morpheus: can not segment word {word!r}")
        end_state = max(finals, key=lambda s: best[s][0])
        morphs = []
        s = end_state
        while best[s][1] is not None:
            morphs.append(best[s][2])
            s = best[s][1]
        morphs.reverse()
        return morphs
