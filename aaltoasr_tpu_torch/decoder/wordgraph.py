"""Word graphs (lattices) from decode records: SLF output and n-best.

Reference: `decoder/src/WordGraph.{hh,cc}` builds an (word, end-frame)
lattice during search (Ortmanns-Ney, `decoder/src/doc/word-graphs`) and
`TokenPassSearch::write_word_graph` (TokenPassSearch.cc:2443-2533) emits
HTK SLF.  Here the lattice falls out of the search's per-frame traceback
records — every surviving word-end record is a lattice arc (word,
start = previous record's frame, end = its frame) with cumulative am/lm
scores, so arc scores are simple differences.

SLF layout matches the reference: VERSION/base/dir/lmscale/wdpenalty
header, ``I=n\\tt=frame`` nodes, ``J=\\tS=\\tE=\\tW=\\tv=0\\ta=\\tl=``
links with the LM score unscaled and the insertion penalty removed
(TokenPassSearch.cc:2520-2530); <s>/</s> map to !NULL.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field

LN10 = 2.302585092994046


@dataclass
class WGNode:
    index: int
    frame: int


@dataclass
class WGArc:
    source: int          # node index
    target: int
    word: str
    am: float            # am score of the word segment
    lm: float            # unscaled LM score (pron+ngram, penalty removed)


@dataclass
class WordGraph:
    nodes: list = field(default_factory=list)
    arcs: list = field(default_factory=list)
    lm_scale: float = 1.0
    insertion_penalty: float = 0.0
    start_node: int = 0
    end_node: int = 0

    @classmethod
    def from_records(cls, vocab, config, rec_words, rec_prevs, rec_ams,
                     rec_lmss, final_ptr, final_am, final_lms):
        T1, E = rec_words.shape
        g = cls(lm_scale=config.lm_scale,
                insertion_penalty=config.insertion_penalty)

        # collect records reachable backward from every record (all are
        # potential lattice arcs).  Lattice nodes MERGE by
        # (frame, word): the reference creates one graph node per
        # (frame, word_id, lex_node_id) and recombines all hypotheses
        # committing that word there (build_word_graph_aux,
        # TokenPassSearch.cc word-pair approximation via
        # use_word_pair_approximation=true in add_arc) — that merge is
        # what turns the record backpointer TREE into a DAG whose
        # alternative paths reach the end node.
        node_of_key = {}
        g.nodes.append(WGNode(0, 0))        # start node at frame 0

        def node_for(ptr):
            if ptr < 0:
                return 0
            f, slot = divmod(ptr, E)
            key = (f, int(rec_words[f, slot]))
            if key not in node_of_key:
                n = WGNode(len(g.nodes), f + 1)
                g.nodes.append(n)
                node_of_key[key] = n.index
            return node_of_key[key]

        def rec_at(ptr):
            f, slot = divmod(ptr, E)
            return (int(rec_words[f, slot]), int(rec_prevs[f, slot]),
                    float(rec_ams[f, slot]), float(rec_lmss[f, slot]))

        for f in range(T1):
            for slot in range(E):
                w = int(rec_words[f, slot])
                if w < 0:
                    continue
                ptr = f * E + slot
                prev = int(rec_prevs[f, slot])
                if prev >= 0:
                    _, _, pam, plms = rec_at(prev)
                else:
                    pam = plms = 0.0
                am = float(rec_ams[f, slot]) - pam
                # the engine's lm accumulator is natural log; SLF's
                # base=10 convention (and the reference's TreeGram
                # scores) are log10 — convert, then remove the
                # word-insertion penalty (a log10 constant)
                lm = ((float(rec_lmss[f, slot]) - plms) / LN10
                      - config.insertion_penalty)
                word = vocab[w] if 0 <= w < len(vocab) else "!NULL"
                if word in ("<s>", "</s>"):
                    word = "!NULL"
                g.arcs.append(WGArc(node_for(prev), node_for(ptr),
                                    word, am, lm))

        # node merging can produce duplicate (S, E, W) arcs from
        # different hypotheses: keep the best-scoring one, as the
        # reference's WordGraph::add_arc does under the word-pair
        # approximation
        best_arc = {}
        for a in g.arcs:
            k = (a.source, a.target, a.word)
            if (k not in best_arc or a.am + g.lm_scale * a.lm
                    > best_arc[k].am + g.lm_scale * best_arc[k].lm):
                best_arc[k] = a
        g.arcs = list(best_arc.values())

        # final arc: residual score from the last word end to the end
        end = WGNode(len(g.nodes), T1 + 1)
        g.nodes.append(end)
        g.end_node = end.index
        if final_ptr >= 0:
            _, _, pam, plms = rec_at(final_ptr)
        else:
            pam = plms = 0.0
        g.arcs.append(WGArc(node_for(final_ptr), end.index, "!NULL",
                            final_am - pam,
                            (final_lms - plms) / LN10))
        return g

    # -- SLF --------------------------------------------------------------
    def write_slf(self, path_or_file) -> None:
        own = not hasattr(path_or_file, "write")
        f = open(path_or_file, "w") if own else path_or_file
        try:
            f.write("VERSION=1.1\nbase=10\ndir=f\n")
            f.write(f"lmscale={self.lm_scale:f} "
                    f"wdpenalty={self.insertion_penalty:f}\n")
            f.write(f"N={len(self.nodes)}\tL={len(self.arcs)}\n")
            f.write(f"start={self.start_node} end={self.end_node}\n")
            for n in self.nodes:
                f.write(f"I={n.index}\tt={n.frame}\n")
            for j, a in enumerate(self.arcs):
                f.write(f"J={j}\tS={a.source}\tE={a.target}\tW={a.word}"
                        f"\tv=0\ta={a.am:e}\tl={a.lm:e}\n")
        finally:
            if own:
                f.close()

    # -- n-best -----------------------------------------------------------
    def nbest(self, n: int = 10) -> list:
        """Top-n distinct word sequences by total score
        (am + lm_scale*lm + penalty per word), via best-first search."""
        out_arcs: dict[int, list] = {}
        for a in self.arcs:
            out_arcs.setdefault(a.source, []).append(a)

        def arc_score(a):
            pen = self.insertion_penalty if a.word != "!NULL" else 0.0
            return a.am + self.lm_scale * (a.lm + pen)

        results = []
        seen = set()
        heap = [(-0.0, 0, self.start_node, ())]
        counter = 1
        while heap and len(results) < n:
            negs, _, node, words = heapq.heappop(heap)
            if node == self.end_node:
                if words not in seen:
                    seen.add(words)
                    results.append((list(words), -negs))
                continue
            for a in out_arcs.get(node, []):
                w = words if a.word == "!NULL" else words + (a.word,)
                heapq.heappush(
                    heap, (negs - arc_score(a), counter, a.target, w))
                counter += 1
        return results


def _logaddexp(a, b):
    import math
    if a == float("-inf"):
        return b
    if b == float("-inf"):
        return a
    m = max(a, b)
    return m + math.log1p(math.exp(min(a, b) - m))


def arc_posteriors(graph: WordGraph) -> list:
    """Posterior probability per arc via lattice forward-backward
    (scores = am + lm_scale*lm, log-domain, host)."""
    import collections
    import math
    NEG = float("-inf")
    out_arcs = collections.defaultdict(list)
    in_arcs = collections.defaultdict(list)
    nodes = {graph.start_node, graph.end_node}
    indeg = collections.defaultdict(int)
    for i, a in enumerate(graph.arcs):
        out_arcs[a.source].append(i)
        in_arcs[a.target].append(i)
        indeg[a.target] += 1
        nodes.update((a.source, a.target))

    def score(a):
        pen = graph.insertion_penalty if a.word != "!NULL" else 0.0
        return a.am + graph.lm_scale * (a.lm + pen)

    # topological order
    topo, queue = [], [n for n in nodes if indeg[n] == 0]
    seen_deg = dict(indeg)
    while queue:
        n = queue.pop()
        topo.append(n)
        for i in out_arcs[n]:
            t = graph.arcs[i].target
            seen_deg[t] -= 1
            if seen_deg[t] == 0:
                queue.append(t)

    alpha = collections.defaultdict(lambda: NEG)
    alpha[graph.start_node] = 0.0
    for n in topo:
        for i in out_arcs[n]:
            a = graph.arcs[i]
            alpha[a.target] = _logaddexp(
                alpha[a.target], alpha[n] + score(a))
    beta = collections.defaultdict(lambda: NEG)
    beta[graph.end_node] = 0.0
    for n in reversed(topo):
        for i in out_arcs[n]:
            a = graph.arcs[i]
            beta[n] = _logaddexp(beta[n], score(a) + beta[a.target])
    total = alpha[graph.end_node]
    post = []
    for a in graph.arcs:
        lp = alpha[a.source] + score(a) + beta[a.target] - total
        post.append(math.exp(min(lp, 0.0)))
    return post


def confusion_network(graph: WordGraph) -> list:
    """Pivot-aligned confusion network with word posteriors.

    The rectool confidence path (rectool.py:961,1100) derives per-word
    confidences from lattice posteriors; here slots come from the 1-best
    path's word arcs and every other arc joins the slot with maximal
    time overlap.  Returns [(best_word, confidence,
    {word: posterior, ...}), ...].
    """
    post = arc_posteriors(graph)
    best = graph.nbest(1)
    if not best:
        return []
    # pivot arcs: recover by best-first walk marking the 1-best sequence
    # (approximate: use the highest-posterior arc per word position)
    frames = {n.index: n.frame for n in graph.nodes}
    word_arcs = [i for i, a in enumerate(graph.arcs)
                 if a.word != "!NULL"]
    # build slots from the 1-best words in order using best path arcs:
    # walk greedily from start following max-posterior word arcs
    slots = []
    words_1best = best[0][0]
    # pivot spans: choose for each 1-best word the max-posterior arc
    # with that word (in sequence order by start frame)
    used = set()
    cursor = 0
    for w in words_1best:
        cands = [i for i in word_arcs
                 if graph.arcs[i].word == w and i not in used
                 and frames.get(graph.arcs[i].source, 0) >= cursor]
        if not cands:
            cands = [i for i in word_arcs if graph.arcs[i].word == w]
        i = max(cands, key=lambda j: post[j])
        used.add(i)
        a = graph.arcs[i]
        s0 = frames.get(a.source, 0)
        e0 = frames.get(a.target, s0 + 1)
        cursor = s0
        slots.append({"span": (s0, e0), "words": {}})
    # assign every word arc to the best-overlapping slot
    for i in word_arcs:
        a = graph.arcs[i]
        s0 = frames.get(a.source, 0)
        e0 = frames.get(a.target, s0 + 1)
        best_slot, best_ov = None, 0.0
        for sl in slots:
            lo = max(s0, sl["span"][0])
            hi = min(e0, sl["span"][1])
            if hi - lo > best_ov:
                best_ov = hi - lo
                best_slot = sl
        if best_slot is not None:
            best_slot["words"][a.word] = (
                best_slot["words"].get(a.word, 0.0) + post[i])
    out = []
    for w, sl in zip(words_1best, slots):
        conf = min(sl["words"].get(w, 0.0), 1.0)
        out.append((w, conf, dict(sl["words"])))
    return out
