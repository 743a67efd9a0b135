"""Binary n-gram format ("cis-binlm2") — TreeGram interchange.

Reference: `decoder/src/TreeGram.cc:316-470` write_real/read.  Layout::

    cis-binlm2\\n
    backoff\\n | interpolated\\n
    <num_words>\\n
    <word>\\n  (x num_words)
    <order> <num_nodes>\\n
    <count>\\n (x order)
    <nodes>   raw little-endian structs {int32 word, float32 log_prob,
              float32 back_off, int32 child_index} (16 bytes each)

Nodes are grouped by order; each node's children are contiguous in the
next level starting at ``child_index`` and sorted by word id; the child
range ends at the next following node's child start (TreeGram::find_child
convention).  Scores are log10 (ARPA domain); our ArpaLM uses natural
log, so conversion happens on the boundary.
"""

from __future__ import annotations

import numpy as np

from aaltoasr_tpu_torch.formats.arpa import ArpaLM, LN10

FORMAT_STR = b"cis-binlm2\n"
NODE_DTYPE = np.dtype([("word", "<i4"), ("log_prob", "<f4"),
                       ("back_off", "<f4"), ("child_index", "<i4")])


def write_bin(lm: ArpaLM, path, lm_type: str = "backoff") -> None:
    """ArpaLM -> cis-binlm2 file."""
    order = lm.order
    V = len(lm.vocab)

    # build the trie level by level; node key = tuple of word ids
    levels: list[list] = []       # per order: sorted list of gram tuples
    for o in range(1, order + 1):
        levels.append(sorted(lm.ngrams[o].keys()))
    index_of: list[dict] = [dict() for _ in range(order)]

    # assign global indices level by level (children sorted under parent)
    # level 0 sorted by word; level o sorted by (parent_index, word)
    counts = [len(lv) for lv in levels]
    offsets = np.cumsum([0] + counts)
    for o in range(order):
        if o == 0:
            levels[o].sort()
        else:
            levels[o].sort(key=lambda g: (index_of[o - 1][g[:-1]], g[-1]))
        for i, g in enumerate(levels[o]):
            index_of[o][g] = offsets[o] + i

    total = int(offsets[-1])
    nodes = np.zeros(total, dtype=NODE_DTYPE)
    nodes["child_index"] = -1
    for o in range(order):
        for g in levels[o]:
            i = index_of[o][g]
            logp, bo = lm.ngrams[o + 1][g]
            nodes["word"][i] = g[-1]
            nodes["log_prob"][i] = logp / LN10
            nodes["back_off"][i] = bo / LN10
    # child indices: replicate TreeGram::add_gram exactly
    # (`decoder/src/TreeGram.cc:270-300`): a parent's child_index is
    # set to its first child, AND after every insertion the NEXT node's
    # child_index is set to the current end — find_child reads a
    # node's child range as [child_index, next_node.child_index), so
    # the node after the last parent-with-children of a level (the
    # first node of the next level) must carry the range end, not -1
    # (TreeGram.cc:160-184; a -1 there made every lookup under the
    # level's last parent back off)
    for o in range(1, order):
        for i, g in enumerate(levels[o]):
            parent = index_of[o - 1][g[:-1]]
            if nodes["child_index"][parent] < 0:
                nodes["child_index"][parent] = offsets[o] + i
            nodes["child_index"][parent + 1] = offsets[o] + i + 1

    with open(path, "wb") as f:
        f.write(FORMAT_STR)
        f.write((lm_type + "\n").encode())
        f.write(f"{V}\n".encode())
        for w in lm.vocab:
            f.write((w + "\n").encode())
        f.write(f"{order} {total}\n".encode())
        for c in counts:
            f.write(f"{c}\n".encode())
        f.write(nodes.tobytes())


def read_bin(path) -> ArpaLM:
    """cis-binlm2 file -> ArpaLM (natural-log scores)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(FORMAT_STR):
        raise ValueError("TreeGram: invalid file format")
    pos = len(FORMAT_STR)

    def read_line():
        nonlocal pos
        end = data.index(b"\n", pos)
        line = data[pos:end].decode()
        pos = end + 1
        return line

    lm_type = read_line()
    if lm_type not in ("backoff", "interpolated"):
        raise ValueError(f"TreeGram: invalid type: {lm_type}")
    V = int(read_line())
    vocab = [read_line() for _ in range(V)]
    order_s, nodes_s = read_line().split()
    order, total = int(order_s), int(nodes_s)
    counts = [int(read_line()) for _ in range(order)]
    nodes = np.frombuffer(data, dtype=NODE_DTYPE, count=total, offset=pos)

    offsets = np.cumsum([0] + counts)
    ngrams = [dict() for _ in range(order + 1)]
    # reconstruct gram tuples: walk levels, mapping node index -> prefix
    prefix_of = {}
    for o in range(order):
        lo, hi = offsets[o], offsets[o + 1]
        for i in range(lo, hi):
            w = int(nodes["word"][i])
            if o == 0:
                gram = (w,)
            else:
                gram = prefix_of[i] + (w,)
            ngrams[o + 1][gram] = (float(nodes["log_prob"][i]) * LN10,
                                   float(nodes["back_off"][i]) * LN10)
            if o + 1 < order:
                # mark children's prefixes
                ci = int(nodes["child_index"][i])
                if ci >= 0:
                    # children run until the next node's child start
                    nxt = hi_child(nodes, i, offsets[o + 2]
                                   if o + 2 <= order else total, hi)
                    for c in range(ci, nxt):
                        prefix_of[c] = gram
    word_index = {w: i for i, w in enumerate(vocab)}
    return ArpaLM(order=order, vocab=vocab, word_index=word_index,
                  ngrams=ngrams)


def hi_child(nodes, i, level_end, parent_level_end):
    """End of node i's child range: the next parent's child start."""
    j = i + 1
    while j < parent_level_end and nodes["child_index"][j] < 0:
        j += 1
    if j < parent_level_end:
        return int(nodes["child_index"][j])
    return level_end
