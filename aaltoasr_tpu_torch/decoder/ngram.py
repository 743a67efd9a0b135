"""N-gram LM compiled to a backoff FSA, walked on torch tensors.

Counterpart of `aaltoasr_tpu/decoder/ngram.py` (the reference's fsalm,
`decoder/src/fsalm/LM.{hh,cc}`).  `NGramFsa` is a host copy: states are
the observed n-gram contexts, transitions one array sorted by (state,
word).  A walk from state ``h`` on word ``w`` takes the explicit
transition if ``h·w`` is an n-gram (score ln P(w|h), next state the
longest suffix of ``h·w`` that is a context), otherwise adds backoff(h)
and retries from suffix(h).

`lm_walk_device` is the vectorized walk.  The empty-context state
resolves with one dense gather; other states look (state, word) up in a
bucketed hash table whose bucket ids are bit-identical to the
reference's (its uint32 hash is computed here in int64 under the same
mask).

`InterNGramFsa` interpolates K member FSAs over a union vocabulary
(`lm_walk_device_multi` walks every member and mixes the scores in the
probability domain).  The engines carry its K member states as one int64
mixed-radix code, member 0 the most significant digit
(`InterNGramFsa.encode`/`decode`): a code orders as the tuple of member
states does, so the recombination key (node, code) keeps the reference's
lexicographic (node, state 0, ..., state K-1) order.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from aaltoasr_tpu_torch.formats.arpa import ArpaLM

NEG_INF = -1.0e30


@dataclass
class NGramFsa:
    order: int
    vocab: list
    word_index: dict
    num_states: int
    context_of_state: list          # state id -> context tuple
    state_of_context: dict          # context tuple -> state id
    trans_word: np.ndarray          # [M] int32, grouped by state, sorted
    trans_prob: np.ndarray          # [M] float32 ln P
    trans_next: np.ndarray          # [M] int32
    state_first: np.ndarray         # [num_states + 1] row offsets into M
    bo_weight: np.ndarray           # [num_states] float32
    bo_next: np.ndarray             # [num_states] int32
    num_words: int

    @classmethod
    def from_arpa(cls, lm: ArpaLM) -> "NGramFsa":
        order = lm.order
        V = len(lm.vocab)
        contexts = {(): 0}
        context_list = [()]

        def intern(ctx):
            if ctx not in contexts:
                contexts[ctx] = len(context_list)
                context_list.append(ctx)
            return contexts[ctx]

        # contexts = all grams of order < n (they can carry history)
        for o in range(1, order):
            for words in lm.ngrams[o]:
                intern(words)

        def next_state(ctx, w):
            """Longest suffix of ctx+(w,) (capped to order-1) that is a
            known context."""
            t = (ctx + (w,))[-(order - 1):] if order > 1 else ()
            while t and t not in contexts:
                t = t[1:]
            return contexts[t]

        keys, probs, nexts = [], [], []
        S = len(context_list)
        for o in range(1, order + 1):
            for words, (logp, _bo) in lm.ngrams[o].items():
                ctx, w = words[:-1], words[-1]
                if ctx not in contexts:
                    continue  # unreachable context (pruned LM)
                s = contexts[ctx]
                keys.append(s * V + w)
                probs.append(logp)
                nexts.append(next_state(ctx, w))

        bo_weight = np.zeros(S, dtype=np.float32)
        bo_next = np.zeros(S, dtype=np.int32)
        for ctx, s in contexts.items():
            if ctx:
                bo_weight[s] = lm.ngrams[len(ctx)].get(ctx, (0.0, 0.0))[1]
                t = ctx[1:]
                while t and t not in contexts:
                    t = t[1:]
                bo_next[s] = contexts[t]
            else:
                bo_weight[s] = NEG_INF  # no backoff from unigram state
                bo_next[s] = 0

        keys = np.asarray(keys, dtype=np.int64)
        srt = np.argsort(keys, kind="stable")
        keys = keys[srt]
        states = (keys // V).astype(np.int64)
        words = (keys % V).astype(np.int32)
        # CSR-style row offsets per state: transitions grouped by state,
        # word-sorted within each group (int32-safe two-level lookup)
        state_first = np.zeros(S + 1, dtype=np.int32)
        np.add.at(state_first, states + 1, 1)
        state_first = np.cumsum(state_first).astype(np.int32)
        return cls(
            order=order, vocab=list(lm.vocab),
            word_index=dict(lm.word_index),
            num_states=S, context_of_state=context_list,
            state_of_context=contexts,
            trans_word=words,
            trans_prob=np.asarray(probs, dtype=np.float32)[srt],
            trans_next=np.asarray(nexts, dtype=np.int32)[srt],
            state_first=state_first,
            bo_weight=bo_weight, bo_next=bo_next, num_words=V)

    def states_ending_with(self, word_id: int) -> np.ndarray:
        """[num_states] bool: the state's context ends with word_id.

        Used for the word-boundary double-commit prune
        (TokenPassSearch.cc:869-873 "Prune two subsequent word
        boundaries"): a hypothesis's last committed word is word_id
        iff its LM state context ends with it (states are identified
        by context, so only a word_id walk reaches such a state; the
        one blind spot is the empty-context state 0, reached when the
        LM has no context carrying word_id — not the case for any LM
        that actually models the boundary word)."""
        out = np.zeros(self.num_states, dtype=bool)
        for s, ctx in enumerate(self.context_of_state):
            if ctx and ctx[-1] == word_id:
                out[s] = True
        return out

    # -- host walk (reference for tests / host decoding) ------------------
    def walk(self, state: int, word: int) -> tuple[int, float]:
        score = 0.0
        for _ in range(self.order + 1):
            lo, hi = self.state_first[state], self.state_first[state + 1]
            i = lo + np.searchsorted(self.trans_word[lo:hi], word)
            if i < hi and self.trans_word[i] == word:
                return int(self.trans_next[i]), score + float(
                    self.trans_prob[i])
            if self.bo_weight[state] <= NEG_INF / 2:
                return 0, NEG_INF
            score += float(self.bo_weight[state])
            state = int(self.bo_next[state])
        return 0, NEG_INF

    def initial_state(self, sentence_start: str = "<s>") -> int:
        ctx = (self.word_index[sentence_start],) if (
            sentence_start in self.word_index and self.order > 1) else ()
        while ctx and ctx not in self.state_of_context:
            ctx = ctx[1:]
        return self.state_of_context[ctx]

    # -- device tables ----------------------------------------------------
    def device_tables(self, device: torch.device | str = "cpu") -> dict:
        """Tensors for `lm_walk_device`: the dense empty-context row,
        the backoff arrays and the (state, word) hash buckets."""
        # the empty-context state 0 holds every unigram, so lookups
        # there are one gather (and it ends every backoff chain)
        V = self.num_words
        uni_prob = np.full(V, NEG_INF, dtype=np.float32)
        uni_next = np.zeros(V, dtype=np.int64)
        lo, hi = int(self.state_first[0]), int(self.state_first[1])
        uni_prob[self.trans_word[lo:hi]] = self.trans_prob[lo:hi]
        uni_next[self.trans_word[lo:hi]] = self.trans_next[lo:hi]
        h = self.hash_tables()

        def dev(a, dtype=None):
            return torch.as_tensor(a, dtype=dtype, device=device)

        return {
            "uni_prob": dev(uni_prob), "uni_next": dev(uni_next),
            "bo_weight": dev(self.bo_weight),
            "bo_next": dev(self.bo_next, torch.int64),
            "hash_state": dev(h["hash_state"], torch.int64),
            "hash_word": dev(h["hash_word"], torch.int64),
            "hash_next": dev(h["hash_next"], torch.int64),
            "hash_prob": dev(h["hash_prob"]),
            "hash_mask": h["hash_mask"],
        }

    _HASH_MUL_S = np.uint32(2654435761)
    _HASH_MUL_W = np.uint32(40503)

    def hash_tables(self, bucket_slots: int = 8) -> dict:
        """Bucketed hash of the non-root transitions, placed exactly as
        the reference places them: ``[nb, L]`` arrays of (state, word,
        next, prob), empty slots state = word = -1.  Every key lands in
        its home bucket ``((state*2654435761) ^ (word*40503)) & (nb-1)``
        (uint32 arithmetic); the bucket count doubles until no bucket
        holds more than ``bucket_slots`` keys."""
        rows = slice(int(self.state_first[1]), len(self.trans_word))
        states = np.repeat(
            np.arange(self.num_states, dtype=np.int64),
            np.diff(self.state_first))[rows].astype(np.uint32)
        words = self.trans_word[rows].astype(np.uint32)
        nexts = self.trans_next[rows]
        probs = self.trans_prob[rows]
        M = len(words)
        L = bucket_slots
        nb = 4
        while nb * L < max(2 * M, 16):
            nb *= 2
        while True:
            bmask = np.uint32(nb - 1)
            h0 = ((states * self._HASH_MUL_S)
                  ^ (words * self._HASH_MUL_W)) & bmask
            # stable-sort keys by home bucket; slot = rank in the bucket
            order = np.argsort(h0, kind="stable")
            hs = h0[order]
            first = np.zeros(len(hs), np.int64)
            if len(hs):
                new = np.flatnonzero(np.diff(hs.astype(np.int64)) != 0)
                first[new + 1] = new + 1
                first = np.maximum.accumulate(first)
            slot = np.arange(len(hs)) - first
            if len(hs) == 0 or slot.max() < L:
                break
            nb *= 2                       # some bucket overflows: grow
        h_state = np.full(nb * L, -1, np.int32)
        h_word = np.full(nb * L, -1, np.int32)
        h_next = np.zeros(nb * L, np.int32)
        h_prob = np.zeros(nb * L, np.float32)
        idx = hs.astype(np.int64) * L + slot
        h_state[idx] = states[order].astype(np.int32)
        h_word[idx] = words[order].astype(np.int32)
        h_next[idx] = nexts[order]
        h_prob[idx] = probs[order]
        return {"hash_state": h_state.reshape(nb, L),
                "hash_word": h_word.reshape(nb, L),
                "hash_next": h_next.reshape(nb, L),
                "hash_prob": h_prob.reshape(nb, L),
                "hash_mask": int(bmask)}


def hash_bucket(state: torch.Tensor, word: torch.Tensor,
                mask: int) -> torch.Tensor:
    """Home bucket of (state, word): the reference's uint32 hash
    ``((state*2654435761) ^ (word*40503)) & mask``, in int64.  The mask
    keeps only bits below 2**32, and low bits of a product do not depend
    on the bits above them, so the wrapped and the exact products agree
    there (states and words are below 2**31, so no int64 overflow)."""
    s = state.to(torch.int64)
    w = word.to(torch.int64)
    return ((s * 2654435761) ^ (w * 40503)) & mask


def lm_walk_device(tables: dict, order: int, state: torch.Tensor,
                   word: torch.Tensor):
    """Vectorized FSA walk: (state [...], word [...]) -> (next, score).

    The empty-context state 0 resolves with one dense gather; other
    states read their hash bucket (at most one of its slots matches,
    since keys are unique).  Backoff hops unroll ``order`` times with
    masking: contexts are shorter than ``order``, so ``order`` hops
    always reach state 0.
    """
    state = state.to(torch.int64)
    word = word.to(torch.int64)
    mask = tables["hash_mask"]
    score = torch.zeros(state.shape, dtype=torch.float32, device=state.device)
    next_state = torch.zeros_like(state)
    done = torch.zeros(state.shape, dtype=torch.bool, device=state.device)
    # the dense row depends only on the word: gather it once
    up = tables["uni_prob"][word]
    un = tables["uni_next"][word]
    uni_hit0 = up > NEG_INF / 2
    for _ in range(order):
        is_uni = state == 0
        h = hash_bucket(state, word, mask)
        m = ((tables["hash_state"][h] == state[..., None])
             & (tables["hash_word"][h] == word[..., None]))  # [..., L]
        hit = m.any(dim=-1)
        l_next = torch.where(m, tables["hash_next"][h], 0).sum(dim=-1)
        l_prob = torch.where(m, tables["hash_prob"][h], 0.0).sum(dim=-1)
        hit = torch.where(is_uni, uni_hit0, hit)
        nxt = torch.where(is_uni, un, l_next)
        sc = torch.where(is_uni, up, l_prob)
        take = hit & ~done
        next_state = torch.where(take, nxt, next_state)
        score = torch.where(take, score + sc, score)
        done = done | hit
        bo = tables["bo_weight"][state]
        bnxt = tables["bo_next"][state]
        dead = ~done & (bo <= NEG_INF / 2)
        score = torch.where(dead, torch.full_like(score, NEG_INF), score)
        done = done | dead
        score = torch.where(done, score, score + bo)
        state = torch.where(done, state, bnxt)
    return next_state, score


def lm_walk_device_multi(lm, tables_list: list, states: torch.Tensor,
                         word: torch.Tensor):
    """Joint walk of the K member FSAs of ``lm`` (`InterNGramFsa`; the
    reference's InterTreeGram, `decoder/src/InterTreeGram.hh:41`):
    (states [..., K], word [...]) -> (next [..., K], score), the score
    the probability-domain mixture of the members' scores (NEG_INF where
    every member is dead)."""
    nxts, scores = [], []
    for k, tab in enumerate(tables_list):
        nxt, sc = lm_walk_device(tab, lm.members[k].order, states[..., k],
                                 word)
        nxts.append(nxt)
        scores.append(lm.log_coeffs[k] + sc)
    stacked = torch.stack(scores).clamp(min=NEG_INF)
    # logsumexp as the reference computes it: max + log(sum(exp(x - max)))
    mx = stacked.max(dim=0).values
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    score = torch.log(torch.exp(stacked - mx).sum(dim=0)) + mx
    score = torch.where((stacked <= NEG_INF / 2).all(dim=0),
                        torch.full_like(score, NEG_INF), score)
    return torch.stack(nxts, dim=-1), score


class InterNGramFsa:
    """Linear interpolation of K backoff FSAs over a union vocabulary
    (`decoder/src/InterTreeGram.{hh,cc}`): decoding walks every member
    and mixes in the probability domain.  A state is K member states."""

    def __init__(self, members: list, coeffs: list):
        if len(members) != len(coeffs):
            raise ValueError(
                "There must be as many interpolation coeffs as LMs")
        if not 0.99 <= sum(coeffs) <= 1.01:
            raise ValueError("Interpolation coeffs must sum to 1")
        self.members = list(members)
        self.coeffs = [float(c) for c in coeffs]
        self.log_coeffs = [float(np.log(max(c, 1e-30))) for c in coeffs]
        self.order = max(m.order for m in members)
        # members are built over the union vocabulary (from_arpas)
        self.num_words = members[0].num_words
        self.word_index = dict(members[0].word_index)
        # mixed-radix state codes: member k's digit has weight
        # prod(num_states of members k+1..K-1)
        self.radix = []
        w = 1
        for m in reversed(self.members):
            self.radix.insert(0, w)
            w *= m.num_states
        self.num_codes = w
        if self.num_codes >= 2 ** 62:
            raise ValueError(
                "the product of the member LMs' state counts does not fit "
                "one int64 state code")

    @property
    def vocab(self):
        return self.members[0].vocab

    @classmethod
    def from_arpas(cls, arpas: list, coeffs: list) -> "InterNGramFsa":
        """Remap every member onto the union vocabulary, then compile
        each to its FSA."""
        union: list = []
        index: dict = {}
        for lm in arpas:
            for w in lm.vocab:
                if w not in index:
                    index[w] = len(union)
                    union.append(w)
        members = []
        for lm in arpas:
            remap = np.asarray([index[w] for w in lm.vocab], dtype=np.int64)

            def rekey(d):
                return {tuple(int(remap[w]) for w in k): v
                        for k, v in d.items()}

            members.append(NGramFsa.from_arpa(ArpaLM(
                order=lm.order, vocab=list(union), word_index=dict(index),
                ngrams=[rekey(g) for g in lm.ngrams])))
        return cls(members, coeffs)

    def initial_state(self, sentence_start: str = "<s>") -> np.ndarray:
        return np.asarray(
            [m.initial_state(sentence_start) for m in self.members],
            dtype=np.int32)

    def member_tables(self, device: torch.device | str = "cpu") -> list:
        return [m.device_tables(device) for m in self.members]

    def walk(self, states, word: int):
        """Host walk: (member states, word) -> (next states, score)."""
        nxts, scs = [], []
        for k, m in enumerate(self.members):
            n, sc = m.walk(int(states[k]), word)
            nxts.append(n)
            scs.append(self.log_coeffs[k] + sc)
        best = max(scs)
        if best <= NEG_INF / 2:
            return nxts, NEG_INF
        return nxts, best + math.log(sum(math.exp(s - best) for s in scs))

    # -- mixed-radix state codes -------------------------------------------
    def encode(self, states):
        """[..., K] member states (tensor or sequence) -> their codes."""
        if not isinstance(states, torch.Tensor):
            return sum(int(s) * r for s, r in zip(states, self.radix))
        code = states[..., 0].to(torch.int64) * self.radix[0]
        for k in range(1, len(self.members)):
            code = code + states[..., k].to(torch.int64) * self.radix[k]
        return code

    def decode(self, code: torch.Tensor) -> torch.Tensor:
        """[...] codes -> [..., K] member states."""
        return torch.stack([(code // r) % m.num_states for r, m in
                            zip(self.radix, self.members)], dim=-1)


# -- LM states as the engines carry them: one int64 code per hypothesis ---
def lm_members(lm) -> list:
    return lm.members if isinstance(lm, InterNGramFsa) else [lm]


def lm_num_codes(lm) -> int:
    return lm.num_codes if isinstance(lm, InterNGramFsa) else lm.num_states


def lm_tables(lm, device) -> dict | list:
    """The device tables `walk_codes` takes."""
    if isinstance(lm, InterNGramFsa):
        return lm.member_tables(device)
    return lm.device_tables(device)


def initial_code(lm, sentence_start: str = "<s>") -> int:
    st = lm.initial_state(sentence_start)
    return lm.encode(st) if isinstance(lm, InterNGramFsa) else int(st)


def reset_code(lm, word: str) -> int:
    """The code after the sentence start and ``word`` in every member
    (members without ``word`` stay at their start), scores discarded:
    the morph-mode sentence-end reset (TokenPassSearch.cc:903-919)."""
    states = []
    for m in lm_members(lm):
        st = m.initial_state()
        w = m.word_index.get(word, -1)
        if w >= 0:
            st, _ = m.walk(st, w)
        states.append(st)
    if isinstance(lm, InterNGramFsa):
        return lm.encode(states)
    return int(states[0])


def member0_states(lm, codes: torch.Tensor) -> torch.Tensor:
    """The first member's state of each code."""
    if isinstance(lm, InterNGramFsa):
        return codes // lm.radix[0]
    return codes


def walk_codes(lm, tables, codes: torch.Tensor, word: torch.Tensor):
    """(codes [...], word [...]) -> (next codes, score): `lm_walk_device`,
    or for an interpolated LM the members' joint walk."""
    if not isinstance(lm, InterNGramFsa):
        return lm_walk_device(tables, lm.order, codes, word)
    nxt, sc = lm_walk_device_multi(lm, tables, lm.decode(codes), word)
    return lm.encode(nxt), sc
