"""The decode task of a morph configuration, as plain data.

Statistical morphs with a word-boundary unit ``<w>`` and a high-order
backoff LM over them (Hirsimäki et al., Comput. Speech Lang. 20(4),
2006; AaltoASR `rectool.py:432-496,529-564`).  `morph_task` returns a
task of `task.decode_task`'s shape, so `AsrData` and `files.write_*`
take it:

- morphs: unique phone strings of 1-6 phones over the task's phones,
  each spelled by its phones (``p0`` -> ``a``, ...), so a word joined
  from its morphs reads the same however it is segmented;
- the lexicon: the morphs, ``<w> _`` (under the optional short silence
  the short-silence loop, which commits ``<w>``) and ``</s> __``;
- the tied-state inventory and gamma durations of `decode_task`: each
  cross-word triphone state keyed by (phone, position, left class,
  right class), classes of ``tied_variants``;
- the LM, order ``order``: bigrams join every morph to ``<w>`` and to
  morphs of its own, ``<w>`` to word-initial morphs and ``</s>``, and
  ``<s>`` to ``<w>``; the higher orders are the grams of a text of
  sentences drawn over the bigrams, each order from a shorter start of
  it, so that every n-gram's prefix and suffix are grams too; every
  gram below the top order has a backoff weight.  Log-probs are held
  at the ARPA file's precision, so the program reads the very numbers
  of ``ngrams``;
- ``walk``: a `MorphWalk`, the successor lists `plans` draws the
  planted units from (in place of `decode_task`'s ``follow``).

`plans` plants them (`plan.word_plan` cannot): a long silence first,
then ``<w>`` as a short silence between words that is transparent to
their cross-word contexts, as the program's tree (and the reference's,
`TPLexPrefixTree.cc:822-832`) weaves the optional short silence between
a word's fan-out and the next word's fan-in.

Units are ``words`` (the morphs, then ``<w>``, whose pronunciation is
the short silence ``_``); the LM's vocabulary is ``<s>``, ``</s>``,
then the units, so unit ``i`` is LM word ``i + 2``.
"""

from __future__ import annotations

import math
import zlib

import numpy as np

from portbench.traffic.task import context_label

BOUNDARY = "<w>"
BOS, EOS = 0, 1                  # LM ids of <s> and </s>
# shares of the morphs by length 1-6 (of 26,000: 25, 625, 15,000, 7,000,
# 2,350, 1,000), each length capped at the strings it has
LENGTH_SHARES = (25, 625, 15000, 7000, 2350, 1000)
# chance that a word ends after its 1st, 2nd, 3rd, 4th morph: words of
# 1-4 morphs, 2.2 on average
WORD_END = (0.3, 0.5, 0.55, 1.0)
LN10 = math.log(10.0)


def arpa_round(lp: float) -> float:
    """``lp`` (ln) as the ARPA file holds it: 6 decimals of log10."""
    return round(lp / LN10, 6) * LN10


def _morph_strings(rng, num_morphs: int, num_phones: int) -> list:
    """``num_morphs`` distinct phone-index tuples of 1-6 phones."""
    total = sum(LENGTH_SHARES)
    want = [min(num_phones ** (L + 1), round(s * num_morphs / total))
            for L, s in enumerate(LENGTH_SHARES)]
    short = num_morphs - sum(want)
    for L in (2, 3, 4, 5, 1, 0):           # the rest where there is room
        room = num_phones ** (L + 1) - want[L]
        add = max(min(short, room), -want[L])
        want[L] += add
        short -= add
    out = []
    for L, n in enumerate(want, 1):
        codes = rng.choice(num_phones ** L, n, replace=False)
        digits = (codes[:, None] // num_phones ** np.arange(L)[::-1]
                  ) % num_phones
        out += [tuple(int(d) for d in row) for row in digits]
    order = rng.permutation(len(out))
    return [out[i] for i in order]


def _text(rng, bi_succ: dict, wb: int, length: int) -> list:
    """About ``length`` LM ids of sentences ``<s> <w> ... <w> </s>`` of
    4-12 words drawn over the bigrams: words of 1-4 morphs (`WORD_END`),
    each morph a bigram successor of the unit before it."""
    out: list = []
    while len(out) < length:
        u = iter(rng.random(4 * 64).tolist())
        out += [BOS, wb]
        for _ in range(int(rng.integers(4, 13))):
            prev = wb
            for end in WORD_END:
                nxt = bi_succ[prev]
                prev = nxt[int(next(u) * len(nxt))]
                out.append(prev)
                if next(u) < end:
                    break
            out.append(wb)
        out.append(EOS)
    return out


def _ngrams(rng, num_morphs: int, order: int, counts: dict) -> dict:
    """{order: {LM-id tuple: (ln p, ln backoff)}} of the morph LM."""
    M = num_morphs
    wb = M + 2
    morph = np.arange(2, M + 2)
    V = M + 3
    uni_lp = np.log(0.65 / M) + rng.normal(0.0, 0.5, V)
    uni_lp[wb] = np.log(0.3)
    uni_lp[EOS] = np.log(0.05)
    grams = {1: {(w,): float(uni_lp[w]) for w in range(V)}}
    # bigrams: <s> <w>; <w> to word-initial morphs and </s>; each morph
    # to <w> and to morphs of its own
    n_start = min(M, max(1, round(0.3 * M)))
    bi = {(BOS, wb): float(np.log(0.9)), (wb, EOS): float(np.log(0.05))}
    for m in rng.choice(morph, n_start, replace=False):
        bi[(wb, int(m))] = float(np.log(0.01 + 0.05 * rng.random()))
    for m in morph:
        bi[(int(m), wb)] = float(np.log(0.2 + 0.4 * rng.random()))
    target = counts[2]
    per = max(0, (target - len(bi)) // M)
    draws = rng.choice(morph, (M, per + 1))
    probs = np.log(0.01 + 0.05 * rng.random((M, per + 1)))
    i = 0
    while len(bi) < target and i < M * (per + 1):
        j, a = divmod(i, M)              # every morph its j-th first
        bi.setdefault((int(morph[a]), int(draws[a, j])), float(probs[a, j]))
        i += 1
    grams[2] = bi
    # orders 3 up: the grams of a text drawn over the bigrams, each order
    # from a shorter start of the text than the order below, so that
    # every gram's prefix and suffix are grams of the order below
    bi_succ: dict = {}
    for a, b in bi:
        if b != wb and b != EOS and a != BOS:
            bi_succ.setdefault(a, []).append(b)
    text = _text(rng, bi_succ, wb, 2 * counts.get(3, 0) + 64)
    end = len(text)
    for n in range(3, order + 1):
        lp = np.log(0.05 + 0.3 * rng.random(counts[n]))
        new: dict = {}
        i = 0
        while len(new) < counts[n] and i + n <= end - 1:
            g = tuple(text[i:i + n])
            i += 1
            if BOS in g[1:] or EOS in g[:-1]:
                continue                  # across a sentence break
            new.setdefault(g, float(lp[len(new)]))
        end = i + n - 1
        grams[n] = new
    out = {}
    for n, table in grams.items():
        bo = (np.log(0.2 + 0.6 * rng.random(len(table))) if n < order
              else np.zeros(len(table)))
        out[n] = {g: (arpa_round(lp), arpa_round(float(b)))
                  for (g, lp), b in zip(table.items(), bo)}
    return out


class MorphWalk:
    """The successor lists `plans` draws planted units from: `get(prev)`
    takes the unit just drawn (-1 at an utterance's start, which opens
    after ``<s> <w>`` as the LM's sentences do) and returns the units
    that may follow, as unit indices: the successors of the longest
    context of the history that has successors allowed there, morphs
    that leave a context with successors first.  ``<w>`` comes never
    after ``<w>`` and always after a word's 4th morph; where the walk
    has backed off to a bigram context it comes at `WORD_END`'s chance
    for the word's length so far.  `plans` calls it once per unit, in
    the units' order."""

    def __init__(self, ngrams: dict, order: int, num_morphs: int):
        self.order = order
        self.wb = num_morphs + 2
        self.succ: dict = {(): list(range(2, num_morphs + 2))}
        for n in range(2, order + 1):
            for g in ngrams[n]:
                if 2 <= g[-1] <= self.wb:
                    self.succ.setdefault(g[:-1], []).append(g[-1])
        self.hist: tuple = (BOS,)
        self.morphs = 0

    def get(self, prev: int) -> list:
        wb = self.wb
        top = self.order - 1
        if prev < 0:
            self.hist, self.morphs = (BOS, wb), 0
        else:
            v = prev + 2
            self.hist = (self.hist + (v,))[-top:]
            self.morphs = 0 if v == wb else self.morphs + 1
        if self.morphs >= len(WORD_END):
            return [wb - 2]
        h = self.hist
        while True:
            nxt = [w for w in self.succ.get(h, ()) if w != wb
                   or self.morphs > 0]
            if nxt:
                break
            h = h[1:]
        morphs = [w for w in nxt if w != wb]
        keep = [w for w in morphs if (h + (w,))[-top:] in self.succ]
        nxt = keep + [wb] * (len(nxt) - len(morphs))
        if len(h) <= 1 and self.morphs > 0:
            end = WORD_END[self.morphs - 1]
            nxt = (keep or morphs) + [wb] * max(
                1, round(end / (1 - end) * len(keep or morphs)))
        return [w - 2 for w in nxt or morphs]


def morph_task(num_morphs=26000, num_phones=25, seed=0, order=6,
               tied_variants=6, ngram_counts=None) -> dict:
    """The morph task: `decode_task`'s keys, ``walk`` for ``follow``
    (``words`` are the units: the morphs, then ``<w>``).  ``ngram_counts``
    ({order: count}, orders 2 to ``order``) sizes the LM; the unigrams
    are the vocabulary."""
    rng = np.random.default_rng([seed, 20])
    phones = [f"p{i}" for i in range(num_phones)]
    strings = _morph_strings(rng, num_morphs, num_phones)
    prons = [[phones[i] for i in s] for s in strings]
    words = ["".join(chr(ord("a") + i) for i in s) for s in strings]
    lex_lines = [f"{w} " + " ".join(p) for w, p in zip(words, prons)]
    lex_lines += [f"{BOUNDARY} _", "</s>(1.0) __"]
    words.append(BOUNDARY)
    prons.append(["_"])

    def cls(p, salt):
        return zlib.crc32(f"{p}|{salt}".encode()) % tied_variants

    state_key: dict = {}

    def tied_state(c, pos, l, r):
        k = (c, pos, cls(l, 0), cls(r, 1))
        if k not in state_key:
            state_key[k] = len(state_key)
        return state_key[k]

    labels: dict = {}

    def add_tri(l, c, r):
        lbl = f"{l}-{c}+{r}"
        if lbl not in labels:
            labels[lbl] = [tied_state(c, pos, l, r) for pos in range(3)]

    real = prons[:-1]
    classes = sorted({p[0] for p in real} | {p[-1] for p in real} | {"_"})
    for p in real:
        for i in range(1, len(p) - 1):
            add_tri(p[i - 1], p[i], p[i + 1])
        if len(p) == 1:
            for a in classes:
                for b in classes:
                    add_tri(a, p[0], b)
            continue
        for c in classes:
            add_tri(c, p[0], p[1])
            add_tri(p[-2], p[-1], c)
    sil0 = len(state_key)
    S = sil0 + 4
    model_phones = dict(labels)
    model_phones["_"] = [sil0]
    model_phones["__"] = [sil0 + 1, sil0 + 2, sil0 + 3]
    durations = np.stack([rng.uniform(1.5, 4.0, S), rng.uniform(1.5, 4.0, S)],
                         axis=1)

    counts = {int(k): int(v) for k, v in (ngram_counts or {}).items()}
    ngrams = _ngrams(rng, num_morphs, order, counts)
    vocab = ["<s>", "</s>"] + words
    return {"lex_lines": lex_lines, "prons": prons, "words": words,
            "phones": model_phones, "num_states": S,
            "transitions": {i: [(0, 0.5), (1, 0.5)] for i in range(S)},
            "durations": durations, "ngrams": ngrams, "order": order,
            "vocab": vocab, "walk": MorphWalk(ngrams, order, num_morphs),
            "silence": "__"}


def lookup_orders(task: dict, units: list) -> list:
    """The order of the n-gram each unit of ``units`` (names) hits in the
    task's LM, walked from ``<s> <w>`` as the planted text is."""
    index = {w: i for i, w in enumerate(task["vocab"])}
    ngrams, top = task["ngrams"], task["order"]
    hist: tuple = (BOS, index[BOUNDARY])
    out = []
    for name in units:
        v = index[name]
        h = hist
        while h and h + (v,) not in ngrams[len(h) + 1]:
            h = h[1:]
        out.append(len(h) + 1)
        hist = (hist + (v,))[-(top - 1):]
    return out


def morph_plan(task: dict, T: int, rng) -> tuple[np.ndarray, list]:
    """One utterance of exactly ``T`` frames of planted units, walked by
    the task's ``walk`` from ``<s> <w>``: a stay in the long silence
    ``__`` opens it, which the lexicon's ``</s> __`` commits as a
    sentence end, restarting the LM at ``<s> <w>`` (the program's tree
    has no short silence before an utterance's first word).  Each
    morph's phones take their tied states
    from their cross-word context, the neighbouring morphs' phones
    across a ``<w>`` (``_`` at the utterance's edges); each ``<w>`` is a
    stay in the short silence.  Stays come from the gamma durations; the
    frames left over go to the last unit's states, evenly.  Returns
    ([T] int32 tied state per frame, the planted unit indices)."""
    prons, dur, labels = task["prons"], task["durations"], task["phones"]
    walk = task["walk"]
    wb = len(prons) - 1
    units: list = []

    def unit(i):
        while len(units) <= i:
            nx = walk.get(units[-1] if units else -1)
            units.append(int(nx[int(rng.integers(len(nx)))]))
        return units[i]

    def across(i, step):
        """The phone next to unit ``i``'s edge in direction ``step``."""
        j = i + step
        while j >= 0 and unit(j) == wb:
            j += step
        return "_" if j < 0 else prons[unit(j)][0 if step > 0 else -1]

    def states_of(i):
        p = prons[unit(i)]
        if unit(i) == wb:
            return list(labels["_"])
        seg = []
        for j, c in enumerate(p):
            left = p[j - 1] if j > 0 else across(i, -1)
            right = p[j + 1] if j + 1 < len(p) else across(i, 1)
            seg += labels[context_label(labels, left, c, right)]
        return seg

    # the leading long silence, which the program's lexicon commits as
    # </s>, restarting its LM at <s> <w>
    lead = [(s, int(np.clip(round(rng.gamma(*dur[s])), 1, 12)))
            for s in labels["__"]]
    stays: list = [lead]
    used = sum(d for _, d in lead)
    n = 0
    for i in range(64 * T):
        seg = states_of(i)
        d = [int(np.clip(round(rng.gamma(*dur[s])), 1, 12)) for s in seg]
        if used + sum(d) > T:
            break
        stays.append(list(zip(seg, d)))
        used += sum(d)
        n = i + 1
    if not n:                    # the first unit alone: a frame a state
        stays = [[(s, 1) for s in states_of(0)]]
        used, n = len(stays[0]), 1
    last = stays[-1]
    rest = T - used
    extra = np.full(len(last), rest // len(last))
    extra[:rest % len(last)] += 1
    stays[-1] = [(s, d + int(e)) for (s, d), e in zip(last, extra)]
    plan = np.concatenate([np.full(d, s, np.int32)
                           for seg in stays for s, d in seg])
    return plan, units[:n]


def plans(task: dict, lengths: np.ndarray, seed: int) -> tuple:
    """Plans of every utterance of a run, as `plan.plans` draws them:
    (list of [T] plans, list of planted unit indices)."""
    rng = np.random.default_rng([seed, 1])
    out = [morph_plan(task, int(T), rng) for T in lengths]
    return [p for p, _ in out], [w for _, w in out]
