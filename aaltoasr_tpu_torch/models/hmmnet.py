"""Hmmnet FSTs compiled to dense position graphs + numerator builders.

Host copy of `aaltoasr_tpu/models/hmmnet.py`.

The reference runs beam-pruned backward/forward directly over the FST
with in-frame epsilon propagation (`aku/HmmNetBaumWelch.cc:817-1200`).
The TPU compile eliminates epsilons up front:

* positions = emitting arcs (arc-synchronous/Mealy form);
* an edge p -> q exists when q's source node is epsilon-reachable from
  p's target node, weighted by the best epsilon path's static score;
* entry[p] = epsilon path score from the initial node to p's source;
  final[p] = epsilon path score from p's target to the final node;
* per-position constants: arc static score + ln(transition prob)
  (the tr_coef of `get_arc_score`, HmmNetBaumWelch.cc:1917-1943),
  added to the observation row once per frame.

The result plugs straight into `train.estep.masked_forward_backward`;
transition statistics come from arc occupancies via ``arc_slot``.

`transcript_hmmnet` builds numerator networks from phone transcripts with
optional-silence insertion — the Python-native replacement for the
`create_hmmnets.pl` + mitfst composition pipeline (aku/scripts/
create_hmmnets.pl:1-40).
"""

from __future__ import annotations

import heapq
import math

import numpy as np

from aaltoasr_tpu_torch.formats.fst import EPSILON, Fst, FstArc
from aaltoasr_tpu_torch.formats.model_io import HmmModel
from aaltoasr_tpu_torch.models.hmm import TransitionTable
from aaltoasr_tpu_torch.ops.logsemiring import LOG_ZERO


def _eps_closure(num_nodes: int, eps_arcs: list) -> list:
    """Best-score epsilon closure per node: node -> {reachable: score}.

    Dijkstra-style on -score (scores are log-probs <= 0 typically, but
    static scores may be arbitrary; best = max total score path).
    """
    out = [dict() for _ in range(num_nodes)]
    adj = [[] for _ in range(num_nodes)]
    for (s, t, w) in eps_arcs:
        adj[s].append((t, w))
    for start in range(num_nodes):
        best = {start: 0.0}
        heap = [(-0.0, start)]
        while heap:
            negw, n = heapq.heappop(heap)
            w = -negw
            if w < best.get(n, -np.inf) - 1e-12:
                continue
            for (t, aw) in adj[n]:
                nw = w + aw
                if nw > best.get(t, -np.inf) + 1e-12:
                    best[t] = nw
                    heapq.heappush(heap, (-nw, t))
        out[start] = best
    return out


def compile_hmmnet(fst: Fst, table: TransitionTable,
                   acoustic_scale: float = 1.0,
                   use_transition_probs: bool = True,
                   use_static_scores: bool = True):
    """Compile an FST to the dense position-graph dict (host, NumPy).

    Returns (graph_arrays, positions_meta) where graph_arrays carries
    pdf/in_*/out_*/entry/final/arc_slot/obs_const and positions_meta maps
    position -> original arc index (for lattice/label extraction).
    """
    emit = [i for i, a in enumerate(fst.arcs)
            if a.transition_index != EPSILON]
    eps = [(a.source, a.target,
            a.score if use_static_scores else 0.0)
           for a in fst.arcs if a.transition_index == EPSILON]
    closure = _eps_closure(fst.num_nodes, eps)

    P = len(emit)
    pdf = np.zeros(P, dtype=np.int32)
    slot = np.zeros(P, dtype=np.int32)
    obs_const = np.zeros(P, dtype=np.float32)
    entry = np.full(P, LOG_ZERO, dtype=np.float32)
    final = np.full(P, LOG_ZERO, dtype=np.float32)
    log_probs = table.log_probs()

    for p, ai in enumerate(emit):
        a = fst.arcs[ai]
        slot[p] = a.transition_index
        pdf[p] = table.source[a.transition_index]
        c = a.score if use_static_scores else 0.0
        if use_transition_probs:
            c += acoustic_scale * log_probs[a.transition_index]
        obs_const[p] = c
        e = closure[fst.initial].get(a.source)
        if e is not None:
            entry[p] = e
        f = closure[a.target].get(fst.final)
        if f is not None:
            final[p] = f

    # edges: p -> q if q.source in closure(p.target)
    by_source: dict[int, list] = {}
    for q, ai in enumerate(emit):
        by_source.setdefault(fst.arcs[ai].source, []).append(q)
    edges = []       # (src_pos, tgt_pos, weight)
    for p, ai in enumerate(emit):
        tgt_node = fst.arcs[ai].target
        for node, w in closure[tgt_node].items():
            for q in by_source.get(node, []):
                edges.append((p, q, w))

    fan_in = np.zeros(P, dtype=np.int64)
    fan_out = np.zeros(P, dtype=np.int64)
    for (s, t, w) in edges:
        fan_in[t] += 1
        fan_out[s] += 1
    F = max(int(fan_in.max(initial=1)), int(fan_out.max(initial=1)), 1)

    in_src = np.tile(np.arange(P, dtype=np.int32)[:, None], (1, F))
    in_logp = np.full((P, F), LOG_ZERO, dtype=np.float32)
    in_slot = np.zeros((P, F), dtype=np.int32)
    out_tgt = np.tile(np.arange(P, dtype=np.int32)[:, None], (1, F))
    out_logp = np.full((P, F), LOG_ZERO, dtype=np.float32)
    ni = np.zeros(P, dtype=np.int64)
    no = np.zeros(P, dtype=np.int64)
    for (s, t, w) in edges:
        in_src[t, ni[t]] = s
        in_logp[t, ni[t]] = w
        in_slot[t, ni[t]] = slot[t]
        ni[t] += 1
        out_tgt[s, no[s]] = t
        out_logp[s, no[s]] = w
        no[s] += 1

    # first-level logical arc (phone instance) id per position: used by
    # multipath-Viterbi segmentation (HmmNetBaumWelch.hh:46-52) and the
    # segment-level MPE error modes.  Arcs built by _expand_phone carry
    # exact ids; file-read FSTs fall back to same-label connected
    # components over the position graph (the reference identifies
    # logical arcs via the ';'-hierarchy labels, HmmNetBaumWelch.hh:25).
    inst = np.full(P, -1, dtype=np.int64)
    for p, ai in enumerate(emit):
        inst[p] = fst.arcs[ai].inst
    if np.any(inst < 0):
        parent = np.arange(P, dtype=np.int64)

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        labels_ = [fst.arcs[ai].label for ai in emit]
        for (s_, t_, _w) in edges:
            if s_ != t_ and labels_[s_] == labels_[t_]:
                parent[find(s_)] = find(t_)
        inst = np.asarray([find(p) for p in range(P)], dtype=np.int64)
    # densify ids
    _, inst = np.unique(inst, return_inverse=True)

    # multipath-Viterbi realization groups: the reference maxes arcs
    # sharing (source node, first-level logical arc) during the
    # backward pass (HmmNetBaumWelch.cc:904-985 groups active
    # transitions per source node, then per parent_arc) — dense ids of
    # that pair
    src_nodes = np.asarray([fst.arcs[ai].source for ai in emit],
                           dtype=np.int64)
    _, mpv_gid = np.unique(src_nodes * (inst.max(initial=0) + 2)
                           + inst, return_inverse=True)

    graph = {
        "pdf": pdf, "in_src": in_src, "in_logp": in_logp,
        "in_slot": in_slot, "out_tgt": out_tgt, "out_logp": out_logp,
        "entry": entry, "final": final,
        "num_positions": np.int32(P),
        "arc_slot": slot,
        "obs_const": obs_const,
        "inst": inst.astype(np.int32),
        "mpv_gid": mpv_gid.astype(np.int32),
        "src_node": src_nodes.astype(np.int32),
        "word_inst": np.asarray(
            [fst.arcs[ai].word_inst for ai in emit], np.int32),
    }
    return graph, emit


def pad_hmmnet(graph: dict, pad_positions: int, fan: int = 0) -> dict:
    """Pad a compiled hmmnet graph to fixed (P, F) for batched jit."""
    P = int(graph["num_positions"])
    F = graph["in_src"].shape[1]
    Fp = max(F, fan)
    Pp = pad_positions
    if P > Pp:
        raise ValueError("hmmnet exceeds padding")

    def pad2(a, fill, self_ref=False):
        out = np.full((Pp, Fp), fill, dtype=a.dtype)
        if self_ref:
            out[:] = np.arange(Pp, dtype=a.dtype)[:, None]
        out[:P, :F] = a
        return out

    def pad1(a, fill):
        out = np.full(Pp, fill, dtype=a.dtype)
        out[:P] = a
        return out

    return {
        "pdf": pad1(graph["pdf"], 0),
        "in_src": pad2(graph["in_src"], 0, self_ref=True),
        "in_logp": pad2(graph["in_logp"], LOG_ZERO),
        "in_slot": pad2(graph["in_slot"], 0),
        "out_tgt": pad2(graph["out_tgt"], 0, self_ref=True),
        "out_logp": pad2(graph["out_logp"], LOG_ZERO),
        "entry": pad1(graph["entry"], LOG_ZERO),
        "final": pad1(graph["final"], LOG_ZERO),
        "num_positions": graph["num_positions"],
        "arc_slot": pad1(graph["arc_slot"], 0),
        "obs_const": pad1(graph["obs_const"], 0.0),
        # padding positions get fresh singleton instances
        "inst": (pad1(graph["inst"], 0) if "inst" in graph else
                 np.arange(Pp, dtype=np.int32)),
        # padding ids >= P can't collide with the dense real groups
        "mpv_gid": (np.concatenate([
            graph["mpv_gid"],
            np.arange(P, Pp, dtype=np.int32)])
            if "mpv_gid" in graph else np.arange(Pp, dtype=np.int32)),
        "src_node": (np.concatenate([
            graph["src_node"],
            graph["src_node"].max(initial=0) + 1
            + np.arange(Pp - P, dtype=np.int32)])
            if "src_node" in graph else np.arange(Pp, dtype=np.int32)),
        "word_inst": (pad1(graph["word_inst"], -1)
                      if "word_inst" in graph
                      else np.full(Pp, -1, dtype=np.int32)),
    }


# ---------------------------------------------------------------------------
# numerator hmmnet construction (create_hmmnets.pl replacement)
# ---------------------------------------------------------------------------

def _expand_phone(fst: Fst, model: HmmModel, table: TransitionTable,
                  label: str, entry_node: int, node) -> int:
    """Wire one phone's HMM between ``entry_node`` and a fresh exit
    node (transition slots as arc input labels); returns the exit."""
    phone = model.phone(label)
    k = len(phone.states)
    inst = entry_node                 # unique per expansion call
    snode = {0: entry_node}
    for i in range(1, k):
        snode[i] = node()
    exit_node = node()
    for i, s in enumerate(phone.states):
        for t in range(table.state_first[s],
                       table.state_first[s] + table.state_count[s]):
            off = int(table.offset[t])
            if i + off < k:
                tgt = snode[i + off]
            elif i + off == k:
                tgt = exit_node
            else:
                continue
            fst.add_arc(FstArc(snode[i], tgt, int(t), label=label,
                               inst=inst))
    return exit_node

def transcript_hmmnet(model: HmmModel, table: TransitionTable,
                      labels: list, optional_silence: str = "_",
                      silence_in_between: bool = True) -> Fst:
    """Numerator FST for a phone transcript.

    Phones expand to their HMM transition arcs (self-loops + forward +
    exit); optionally an optional-silence branch is inserted between
    phones and at the ends — the standard create_hmmnets construction
    (aku/scripts/create_hmmnets.pl builds the same via lex2fst + mitfst
    composition).
    """
    fst = Fst()
    next_node = [0]

    def node():
        n = next_node[0]
        next_node[0] += 1
        fst.num_nodes = max(fst.num_nodes, n + 1)
        return n

    def add_phone(label, entry_node):
        return _expand_phone(fst, model, table, label, entry_node, node)

    start = node()
    fst.initial = start
    cur = start
    has_sil = optional_silence and any(
        p.label == optional_silence for p in model.phones)

    def maybe_silence(at):
        """Optional silence: epsilon bypass + silence branch."""
        if not has_sil:
            return at
        out = node()
        fst.add_arc(FstArc(at, out))                 # epsilon skip
        sil_entry = node()
        fst.add_arc(FstArc(at, sil_entry))           # epsilon into silence
        sil_exit = add_phone(optional_silence, sil_entry)
        fst.add_arc(FstArc(sil_exit, out))
        return out

    cur = maybe_silence(cur)
    for i, label in enumerate(labels):
        if label == optional_silence:
            continue  # silences are optional everywhere already
        entry = node()
        fst.add_arc(FstArc(cur, entry))
        cur = add_phone(label, entry)
        if silence_in_between or i == len(labels) - 1:
            cur = maybe_silence(cur)
    fst.final = cur
    return fst


# ---------------------------------------------------------------------------
# denominator hmmnet construction (generate_den_hmmnets.pl replacement)
# ---------------------------------------------------------------------------

def wordgraph_hmmnet(model: HmmModel, table: TransitionTable,
                     lexicon_entries: list, graph,
                     posterior_prune: float = 0.0) -> Fst:
    """Denominator FST from a decoded word graph.

    The reference pipeline (create_hmmnets.pl:469-480) rescoures the
    recognition lattice, posterior-prunes it with SRI lattice-tool, and
    expands words to HMM transition arcs; here each surviving lattice
    arc expands directly through the lexicon's pronunciations, with the
    scaled LM score as a static score on the entry epsilon arc.

    posterior_prune: drop lattice arcs whose posterior is below this
    (lattice-tool -posterior-prune).
    """
    from aaltoasr_tpu_torch.decoder.wordgraph import arc_posteriors

    prons: dict = {}
    for e in lexicon_entries:
        prons.setdefault(e.word, []).append(
            (e.phones, np.log(max(e.prob, 1e-30))))

    keep = [True] * len(graph.arcs)
    if posterior_prune > 0.0 and graph.arcs:
        post = arc_posteriors(graph)
        keep = [p >= posterior_prune for p in post]

    fst = Fst()
    next_node = [0]

    def node():
        n = next_node[0]
        next_node[0] += 1
        fst.num_nodes = max(fst.num_nodes, n + 1)
        return n

    wg_node = {}

    def node_for(idx):
        if idx not in wg_node:
            wg_node[idx] = node()
        return wg_node[idx]

    fst.initial = node_for(graph.start_node)
    for arc, k in zip(graph.arcs, keep):
        if not k:
            continue
        src, tgt = node_for(arc.source), node_for(arc.target)
        word = arc.word
        lm = graph.lm_scale * arc.lm
        if word in prons:
            cands = prons[word]
        else:
            # sentence boundaries / bare phone labels (e.g. silence)
            try:
                model.phone(word)
                cands = [([word], 0.0)]
            except (KeyError, ValueError):
                fst.add_arc(FstArc(src, tgt, score=lm, out_label=word))
                continue
        for phones, logp in cands:
            wid = len(fst.word_names)
            fst.word_names.append(word)
            entry = node()
            fst.add_arc(FstArc(src, entry, score=lm + logp,
                               out_label=word))
            cur = entry
            arc0 = len(fst.arcs)
            for i, ph in enumerate(phones):
                if i > 0:
                    nxt = node()
                    fst.add_arc(FstArc(cur, nxt))
                    cur = nxt
                cur = _expand_phone(fst, model, table, ph, cur, node)
            for a in fst.arcs[arc0:]:
                a.word_inst = wid
            fst.add_arc(FstArc(cur, tgt))
    fst.final = node_for(graph.end_node)
    return fst


def union_fst(a: Fst, b: Fst) -> Fst:
    """Union of two hmmnet FSTs (mitfst fst_union): fresh initial and
    final joined by epsilon arcs; b's nodes offset past a's."""
    out = Fst()
    off = a.num_nodes
    ini, fin = a.num_nodes + b.num_nodes, a.num_nodes + b.num_nodes + 1
    out.initial, out.final = ini, fin
    out.num_nodes = fin + 1
    for arc in a.arcs:
        out.add_arc(FstArc(arc.source, arc.target, arc.transition_index,
                           arc.label, arc.out_label, arc.score))
    for arc in b.arcs:
        out.add_arc(FstArc(arc.source + off, arc.target + off,
                           arc.transition_index, arc.label,
                           arc.out_label, arc.score))
    out.add_arc(FstArc(ini, a.initial))
    out.add_arc(FstArc(ini, b.initial + off))
    out.add_arc(FstArc(a.final, fin))
    out.add_arc(FstArc(b.final + off, fin))
    return out
