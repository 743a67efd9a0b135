"""HTK SLF lattice reading, LM rescoring, and lattice best paths.

Reference: `tools/lattice_rescore` (Rescore.{hh,cc}: context-dependent
node expansion against a new TreeGram; lattice_rescore.cc, its CLI).  The
rescoring algorithm is the same context expansion: each (node, LM
context) pair becomes a node of the rescored lattice, arcs get the new
LM score for their word in the incoming context.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from aaltoasr_tpu_torch.formats.arpa import LN10, ArpaLM


@dataclass
class SlfLattice:
    nodes: list = field(default_factory=list)     # frame times
    arcs: list = field(default_factory=list)      # dicts S/E/W/a/l
    lm_scale: float = 1.0
    wdpenalty: float = 0.0
    start: int = 0
    end: int = 0

    @classmethod
    def read(cls, path_or_text) -> "SlfLattice":
        text = path_or_text
        if "\n" not in str(text):
            with open(text) as f:
                text = f.read()
        lat = cls()
        times = {}
        for line in text.splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            fields = {}
            for kv in line.split():
                if "=" in kv:
                    k, _, v = kv.partition("=")
                    fields[k] = v
            if "I" in fields:
                times[int(fields["I"])] = int(float(fields.get("t", 0)))
            elif "J" in fields:
                lat.arcs.append({
                    "S": int(fields["S"]), "E": int(fields["E"]),
                    "W": fields.get("W", "!NULL"),
                    "a": float(fields.get("a", 0.0)),
                    "l": float(fields.get("l", 0.0)),
                })
            else:
                if "lmscale" in fields:
                    lat.lm_scale = float(fields["lmscale"])
                if "wdpenalty" in fields:
                    lat.wdpenalty = float(fields["wdpenalty"])
                if "start" in fields:
                    lat.start = int(fields["start"])
                if "end" in fields:
                    lat.end = int(fields["end"])
        n = max(times) + 1 if times else 0
        lat.nodes = [times.get(i, 0) for i in range(n)]
        return lat

    def write(self, path_or_file) -> None:
        own = not hasattr(path_or_file, "write")
        f = open(path_or_file, "w") if own else path_or_file
        try:
            f.write("VERSION=1.1\nbase=10\ndir=f\n")
            f.write(f"lmscale={self.lm_scale:f} "
                    f"wdpenalty={self.wdpenalty:f}\n")
            f.write(f"N={len(self.nodes)}\tL={len(self.arcs)}\n")
            f.write(f"start={self.start} end={self.end}\n")
            for i, t in enumerate(self.nodes):
                f.write(f"I={i}\tt={t}\n")
            for j, a in enumerate(self.arcs):
                f.write(f"J={j}\tS={a['S']}\tE={a['E']}\tW={a['W']}"
                        f"\tv=0\ta={a['a']:e}\tl={a['l']:e}\n")
        finally:
            if own:
                f.close()

    # -- rescoring --------------------------------------------------------
    def rescore(self, lm: ArpaLM, sentence_start: str = "<s>",
                sentence_end: str = "</s>") -> "SlfLattice":
        """Expand nodes by LM context and replace LM scores.

        Each reachable (node, context) pair becomes a node in the output
        (Rescore::find_or_create_node semantics); contexts are the last
        order-1 LM word ids.
        """
        out = SlfLattice(lm_scale=self.lm_scale,
                         wdpenalty=self.wdpenalty)
        order = lm.order
        start_ctx = ()
        if sentence_start in lm.word_index:
            start_ctx = (lm.word_index[sentence_start],)

        # the reference appends a synthetic sentence-end arc after the
        # final node and rescores it with the new LM
        # (Rescore.cc: "Create a new final node ... add sentence end
        # arc"), so rescored lattices carry an explicit </s> arc whose
        # l is the new LM's sentence-end probability
        vend = len(self.nodes) + len(self.arcs) + 10 ** 6
        arcs = list(self.arcs)
        if sentence_end in lm.word_index:
            arcs.append({"S": self.end, "E": vend, "W": sentence_end,
                         "a": 0.0, "l": 0.0})
            end_node = vend
        else:
            end_node = self.end

        out_arcs_of: dict[int, list] = {}
        for i, a in enumerate(arcs):
            out_arcs_of.setdefault(a["S"], []).append(a)

        node_map = {}

        def get_node(orig, ctx):
            key = (orig, ctx)
            if key not in node_map:
                node_map[key] = len(out.nodes)
                out.nodes.append(self.nodes[orig]
                                 if orig < len(self.nodes) else 0)
            return node_map[key]

        out.start = get_node(self.start, start_ctx)
        final_nodes = []
        stack = [(self.start, start_ctx)]
        seen = {(self.start, start_ctx)}
        while stack:
            orig, ctx = stack.pop()
            src = get_node(orig, ctx)
            if orig == end_node:
                final_nodes.append(src)
                continue
            for a in out_arcs_of.get(orig, []):
                w = a["W"]
                if w in ("!NULL", ""):
                    lm_score = 0.0
                    new_ctx = ctx
                else:
                    wid = lm.word_index.get(w)
                    if wid is None:
                        continue  # word unknown to the LM: prune
                    # ArpaLM.log_prob is natural; SLF's base=10
                    # header (and the reference's rescored lattices,
                    # TreeGram log10 scores) want log10
                    lm_score = lm.log_prob(ctx, wid) / LN10
                    new_ctx = (ctx + (wid,))[-(order - 1):] \
                        if order > 1 else ()
                tgt_key = (a["E"], new_ctx)
                tgt = get_node(a["E"], new_ctx)
                out.arcs.append({"S": src, "E": tgt, "W": w,
                                 "a": a["a"], "l": lm_score})
                if tgt_key not in seen:
                    seen.add(tgt_key)
                    stack.append(tgt_key)

        # single final node: join expanded finals with !NULL arcs
        if len(final_nodes) == 1:
            out.end = final_nodes[0]
        else:
            out.end = len(out.nodes)
            out.nodes.append(self.nodes[self.end]
                             if self.end < len(self.nodes) else 0)
            for fn in final_nodes:
                out.arcs.append({"S": fn, "E": out.end, "W": "!NULL",
                                 "a": 0.0, "l": 0.0})
        return out

    # -- best path --------------------------------------------------------
    def best_path(self) -> tuple:
        """(words, total) via topological DP over am + lm_scale*lm."""
        import collections
        order_in = collections.defaultdict(int)
        out_arcs = collections.defaultdict(list)
        nodes = set([self.start, self.end])
        for a in self.arcs:
            order_in[a["E"]] += 1
            out_arcs[a["S"]].append(a)
            nodes.update((a["S"], a["E"]))
        best = {self.start: (0.0, None, None)}
        queue = [n for n in nodes if order_in[n] == 0]
        topo = []
        while queue:
            n = queue.pop()
            topo.append(n)
            for a in out_arcs[n]:
                order_in[a["E"]] -= 1
                if order_in[a["E"]] == 0:
                    queue.append(a["E"])
        for n in topo:
            if n not in best:
                continue
            score = best[n][0]
            for a in out_arcs[n]:
                s = score + a["a"] + self.lm_scale * a["l"] + (
                    self.wdpenalty if a["W"] != "!NULL" else 0.0)
                if a["E"] not in best or s > best[a["E"]][0]:
                    best[a["E"]] = (s, n, a)
        if self.end not in best:
            return [], float("-inf")
        words = []
        n = self.end
        while n != self.start:
            _, prev, arc = best[n]
            if arc["W"] != "!NULL":
                words.append(arc["W"])
            n = prev
        words.reverse()
        return words, best[self.end][0]

    def nbest(self, k: int) -> list:
        """Top-k unique word sequences as (words, total) by exact A*
        over the DAG (priority = partial score + best-to-end estimate,
        so sequences pop in true total-score order).  The reference
        extracts n-best from the same word-graph artifact
        (`decoder/src/doc/word-graphs`, rectool.py n-best mode)."""
        import collections
        import heapq
        out_arcs = collections.defaultdict(list)
        in_arcs = collections.defaultdict(list)
        nodes = set([self.start, self.end])
        for a in self.arcs:
            out_arcs[a["S"]].append(a)
            in_arcs[a["E"]].append(a)
            nodes.update((a["S"], a["E"]))

        def arc_score(a):
            return a["a"] + self.lm_scale * a["l"] + (
                self.wdpenalty if a["W"] != "!NULL" else 0.0)

        # backward DP: best score from node to end (A* heuristic)
        order_out = {n: len(out_arcs[n]) for n in nodes}
        to_end = {self.end: 0.0}
        queue = [n for n in nodes if order_out[n] == 0]
        while queue:
            n = queue.pop()
            for a in in_arcs[n]:
                if n in to_end:
                    s = to_end[n] + arc_score(a)
                    if s > to_end.get(a["S"], float("-inf")):
                        to_end[a["S"]] = s
                order_out[a["S"]] -= 1
                if order_out[a["S"]] == 0:
                    queue.append(a["S"])
        if self.start not in to_end:
            return []

        heap = [(-to_end[self.start], 0.0, self.start, ())]
        results: list = []
        seen: set = set()
        pops = 0
        limit = 200000                       # DAG: safety bound only
        while heap and len(results) < k and pops < limit:
            neg_f, g, n, words = heapq.heappop(heap)
            pops += 1
            if n == self.end:
                if words not in seen:
                    seen.add(words)
                    results.append((list(words), g))
                continue
            for a in out_arcs[n]:
                if a["E"] not in to_end:
                    continue
                g2 = g + arc_score(a)
                w2 = words if a["W"] == "!NULL" else words + (a["W"],)
                heapq.heappush(
                    heap, (-(g2 + to_end[a["E"]]), g2, a["E"], w2))
        return results

    def oracle_error(self, ref_words: list) -> int:
        """Minimum word edit distance between any lattice path and
        ref_words (oracle WER numerator) — quantifies what lattice
        truncation costs, independent of the 1-best."""
        import collections
        R = len(ref_words)
        out_arcs = collections.defaultdict(list)
        order_in = collections.defaultdict(int)
        nodes = set([self.start, self.end])
        for a in self.arcs:
            out_arcs[a["S"]].append(a)
            order_in[a["E"]] += 1
            nodes.update((a["S"], a["E"]))
        INF = 10 ** 9
        dist = {n: [INF] * (R + 1) for n in nodes}
        dist[self.start] = list(range(R + 1))   # deletions of ref
        queue = [n for n in nodes if order_in[n] == 0]
        topo = []
        while queue:
            n = queue.pop()
            topo.append(n)
            for a in out_arcs[n]:
                order_in[a["E"]] -= 1
                if order_in[a["E"]] == 0:
                    queue.append(a["E"])
        for n in topo:
            row = dist[n]
            # deletions: skip ref words without consuming an arc
            for j in range(1, R + 1):
                if row[j - 1] + 1 < row[j]:
                    row[j] = row[j - 1] + 1
            for a in out_arcs[n]:
                tgt = dist[a["E"]]
                if a["W"] == "!NULL":
                    for j in range(R + 1):
                        if row[j] < tgt[j]:
                            tgt[j] = row[j]
                else:
                    for j in range(R + 1):
                        if row[j] + 1 < tgt[j]:           # insertion
                            tgt[j] = row[j] + 1
                        if j < R:
                            m = row[j] + (a["W"] != ref_words[j])
                            if m < tgt[j + 1]:
                                tgt[j + 1] = m            # sub/match
        row = dist[self.end]
        for j in range(1, R + 1):
            if row[j - 1] + 1 < row[j]:
                row[j] = row[j - 1] + 1
        return row[R]


# ---------------------------------------------------------------------------
# lattice-as-grammar (decoder/src/HTKLatticeGrammar.{hh,cc})
# ---------------------------------------------------------------------------

def lattice_grammar(lat: "SlfLattice", null_word: str = "!NULL"):
    """Compile an HTK lattice into an FSA grammar for the decoder.

    The reference HTKLatticeGrammar is a pure acceptor: a word sequence
    scores 0 when it is a prefix of some lattice path and
    IMPOSSIBLE_LOGPROB otherwise (HTKLatticeGrammar.hh:28-53
    log_prob_bo via match_begin); lattice arc scores are ignored.  Here
    the lattice is subset-determinized over word labels (``!NULL`` arcs
    are epsilon) into the same dense CSR tables the n-gram FSA uses, so
    the decoder's vectorized walk needs no new code: every transition
    scores 0 and every state has no backoff (a miss is a dead path).
    """
    from aaltoasr_tpu_torch.decoder.ngram import NEG_INF, NGramFsa

    # epsilon (!NULL) closure, forward
    eps_adj: dict = {}
    word_arcs: dict = {}
    for a in lat.arcs:
        w = a.get("W", null_word)
        if w == null_word:
            eps_adj.setdefault(a["S"], set()).add(a["E"])
        else:
            word_arcs.setdefault(a["S"], []).append((w, a["E"]))

    def closure(nodes):
        out = set(nodes)
        stack = list(nodes)
        while stack:
            n = stack.pop()
            for m in eps_adj.get(n, ()):
                if m not in out:
                    out.add(m)
                    stack.append(m)
        return frozenset(out)

    vocab: list = []
    word_index: dict = {}

    def wid(w):
        if w not in word_index:
            word_index[w] = len(vocab)
            vocab.append(w)
        return word_index[w]

    start = closure([lat.start])
    subsets = {start: 0}
    order_list = [start]
    trans: list = []                      # (state, word, next_state)
    i = 0
    while i < len(order_list):
        cur = order_list[i]
        s = subsets[cur]
        by_word: dict = {}
        for n in cur:
            for w, e in word_arcs.get(n, ()):
                by_word.setdefault(wid(w), set()).add(e)
        for w, tgts in sorted(by_word.items()):
            nxt = closure(tgts)
            if nxt not in subsets:
                subsets[nxt] = len(order_list)
                order_list.append(nxt)
            trans.append((s, w, subsets[nxt]))
        i += 1

    S = len(order_list)
    V = max(len(vocab), 1)
    keys = np.asarray([s * V + w for s, w, _ in trans], dtype=np.int64)
    srt = np.argsort(keys, kind="stable")
    states = (keys[srt] // V).astype(np.int64)
    words = (keys[srt] % V).astype(np.int32)
    nexts = np.asarray([t for _, _, t in trans],
                       dtype=np.int32)[srt]
    state_first = np.zeros(S + 1, dtype=np.int32)
    np.add.at(state_first, states + 1, 1)
    state_first = np.cumsum(state_first).astype(np.int32)

    return NGramFsa(
        order=1, vocab=vocab, word_index=word_index,
        num_states=S,
        context_of_state=[()] + [None] * (S - 1),
        state_of_context={(): 0},
        trans_word=words,
        trans_prob=np.zeros(len(trans), dtype=np.float32),
        trans_next=nexts,
        state_first=state_first,
        bo_weight=np.full(S, NEG_INF, dtype=np.float32),
        bo_next=np.zeros(S, dtype=np.int32),
        num_words=V)
