"""The decode task of a configuration, as plain data.

A frozen copy of the synthetic task generator of the program
(`synth_task`): the same seed gives the same lexicon, tied-state
inventory, gamma durations and trigram backoff LM.  It returns numpy
arrays and strings only; the run writes them as the files the
program reads (`traffic/files.py`).
"""

from __future__ import annotations

import zlib

import numpy as np


def context_label(phone_labels: dict, left: str, p: str, right: str) -> str:
    """Tied-triphone label with the program's fallbacks:
    l-c+r -> l-c -> c+r -> c."""
    for cand in (f"{left}-{p}+{right}", f"{left}-{p}", f"{p}+{right}", p):
        if cand in phone_labels:
            return cand
    return p


def decode_task(num_words=1000, num_phones=25, seed=0, order=3,
                tied_variants=6) -> dict:
    """Cross-word triphone task with gamma durations: keys ``lex_lines``,
    ``prons`` (phone strings per word), ``words``, ``phones`` (label ->
    state list, in model order), ``transitions`` (state -> [(offset,
    prob)]), ``durations`` [S, 2], ``num_states``, ``ngrams`` (order ->
    {word-id tuple: (ln prob, ln backoff)}), ``vocab``, ``follow`` (word
    -> LM successors, indices into ``words``)."""
    rng = np.random.default_rng(seed)
    phones = [f"p{i}" for i in range(num_phones)] + ["_"]
    D = 39
    lex_lines = ["_ _", "__ __"]
    words, prons = [], []
    for w in range(num_words):
        n = int(rng.integers(3, 9))
        pron = [phones[int(rng.integers(num_phones))] for _ in range(n)]
        prons.append(pron)
        words.append(f"w{w}")
        lex_lines.append(f"w{w} " + " ".join(pron))

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

    classes = sorted({p[0] for p in prons} | {p[-1] for p in prons} | {"_"})
    for p in prons:
        for i in range(1, len(p) - 1):
            add_tri(p[i - 1], p[i], p[i + 1])
        for c in classes:
            add_tri(c, p[0], p[1])
            add_tri(p[-2], p[-1], c)
    sil0 = len(state_key)
    S = sil0 + 4
    model_phones = dict(labels)
    model_phones["_"] = [sil0]
    model_phones["__"] = [sil0 + 1, sil0 + 2, sil0 + 3]
    rng.normal(0, 2, (S, D))       # the generator's state means (unused)
    durations = np.stack([rng.uniform(1.5, 4.0, S), rng.uniform(1.5, 4.0, S)],
                         axis=1)

    vocab = ["<s>", "</s>"] + words
    word_index = {w: i for i, w in enumerate(vocab)}
    uni = {(word_index[v],): (float(np.log(1.0 / len(vocab))), -0.7)
           for v in vocab}
    bi = {}
    for _ in range(num_words * 10):
        a = word_index[words[int(rng.integers(num_words))]]
        b = word_index[words[int(rng.integers(num_words))]]
        bo = -0.5 if order > 2 else 0.0
        bi[(a, b)] = (float(np.log(0.01 + rng.random() * 0.05)), bo)
    ngrams = {1: uni, 2: bi}
    if order >= 3:
        tri = {}
        bikeys = list(bi)
        for _ in range(num_words * 20):
            a, b = bikeys[int(rng.integers(len(bikeys)))]
            c = word_index[words[int(rng.integers(num_words))]]
            tri[(a, b, c)] = (float(np.log(0.02 + rng.random() * 0.1)), 0.0)
        ngrams[3] = tri
    follow: dict = {}
    for (a, b) in bi:
        if a >= 2 and b >= 2:
            follow.setdefault(a - 2, []).append(b - 2)
    return {"lex_lines": lex_lines, "prons": prons, "words": words,
            "phones": model_phones, "num_states": S,
            "transitions": {i: [(0, 0.5), (1, 0.5)] for i in range(S)},
            "durations": durations, "ngrams": ngrams, "order": order,
            "vocab": vocab, "follow": follow, "silence": "__"}


def chain_task(num_states=2500) -> dict:
    """The phone inventory of the training configuration: 2-state
    phones ``p0`` .. with the program's `random_model` transitions
    (self loops 0.7 and 0.6)."""
    phones, transitions = {}, {}
    for i in range(num_states // 2):
        s0, s1 = 2 * i, 2 * i + 1
        phones[f"p{i}"] = [s0, s1]
        transitions[s0] = [(0, 0.7), (1, 0.3)]
        transitions[s1] = [(0, 0.6), (1, 0.4)]
    return {"phones": phones, "transitions": transitions,
            "num_states": num_states}
