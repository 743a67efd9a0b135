"""Search configuration, the exact token-passing engine and its results.

Counterpart of `aaltoasr_tpu/decoder/search.py` (the reference's
`decoder/src/TokenPassSearch.{hh,cc}`): `SearchConfig`, the morph-mode
word list expansion, the multiword and LM-lookahead tables, `BeamSearch`
and the record-carrying `DecodeResult`.

`BeamSearch` keeps a fixed-width token array per utterance and runs one
step per frame, in a Python loop over frames:
1. in-word expansion over the token's arcs (with ``overflow_tokens``: a
   dense [W, 3] table, plus branch arcs for the top-O tokens only);
2. word ends [W, H]: optional static unigram ranking (``we_prewalk``),
   the FSA LM walk, the word-end beam, then the E best word ends become
   this frame's traceback records, and the best ``reentry_records`` of
   them re-enter through their context row [R] (``reentry_prewalk``
   keeps each record's top entry nodes);
3. observation add, global beam, recombination (first candidate per
   (node, LM state) in (node, LM state, -total) order) and the top-W cut.
Scores are total = am + lm_scale * lms with am += transition + duration
and lm += ngram + pronunciation + insertion penalty
(`TokenPassSearch.hh:539-542`).

The step has an explicit batch axis: tokens are [B, W] arrays, where
the reference vmaps a one-utterance step.  The reference's TPU layouts
are not carried over; in their place:
- the row-packed step table with ints riding as float32 values: two
  per-node tables, int64 and float32 (`_RowTable`), one row gather each
  per token and step;
- the three layouts of the observation gather (`_tri`, `_over_shared`,
  ``obs_compose``): one gather of the frame's log-probs at the
  candidates' pdf ids;
- the fused int32 (node, LM state) sort key: an int64 key node * S +
  state and two stable sorts, by -total and then by the key, which give
  the reference's lexicographic stable three-key order;
- ``reentry_prewalk``'s argmax rounds (RK <= 16): the stable top-k that
  the reference uses above 16.  Both give the same entry nodes wherever
  a row has RK live entries; in a shorter row the rounds repeat a live
  entry, which recombination drops behind its first copy, where the
  top-k gives dead entries, so the tokens are the same.
Every top-k is a stable descending sort (ties to the lower index, as
`jax.lax.top_k`).  The records stay on the device until the frame loop
ends (nothing in the loop waits for the device); the 1-best traceback
runs on the host over them.

Log bases (the reference's noway conventions, see the reference
module's docstring): LNA acoustics and gamma durations are natural
log, while HMM transitions and LM scores are log10 in the reference.
The tables here are natural log, so the engines multiply by
``lm_scale / ln10`` and ``transition_scale / ln10`` to give the flags
the reference's meaning; the insertion penalty is a log10-domain
constant, ``insertion_penalty * ln10`` here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from aaltoasr_tpu_torch.decoder.lexicon import (
    PrefixTree, duration_table, node_duration_params)
from aaltoasr_tpu_torch.decoder.ngram import NGramFsa, lm_walk_device
from aaltoasr_tpu_torch.decoder.wordgraph import WordGraph
from aaltoasr_tpu_torch.device import resolve_device
from aaltoasr_tpu_torch.ops.logsemiring import LOG_ZERO

LN10 = 2.302585092994046
NEG_INF = float("-inf")
POS_INF = float("inf")
DEAD_KEY = torch.iinfo(torch.int64).max

# the ROADMAP item that brings what the port does not have yet
EXACT_REST_ITEM = "ROADMAP queue 1 item 4: the rest of the exact engine"


@dataclass
class SearchConfig:
    """Knobs of both engines (the reference's Toolbox setters)."""

    num_tokens: int = 1024          # W: token beam width (fixed array)
    num_records: int = 128          # E: word-end records per frame
    beam: float = 280.0             # global beam (recognize-batch.sh:21)
    lm_scale: float = 30.0
    insertion_penalty: float = 0.0
    transition_scale: float = 1.0
    duration_scale: float = 3.0     # rectool.py:547
    max_dur: int = 64
    lm_lookahead: int = 0           # 0 off, 1 unigram table, 2 bigram
                                    # table (3, context lookahead, is not
                                    # ported yet)
    word_boundary: str = ""         # morph-mode word boundary ('<w>'):
                                    # committed as an LM word, two in a
                                    # row pruned, a mid-utterance
                                    # sentence end resets the LM through
                                    # <s> <w> (TokenPassSearch.cc:869-919)
    require_sentence_end: bool = False  # add P(</s>|h) to final
                                    # hypotheses (TokenPassSearch.cc:2267)
    sentence_end: str = "</s>"
    records_half: bool = False      # dense engine: bf16 record scores
                                    # (halves their device->host bytes;
                                    # lattice scores lose ~3 digits)
    overflow_tokens: int = 0        # >0: in-word arcs as a dense [W, 3]
                                    # table plus branch arcs for the
                                    # top-O tokens only; 0 = every arc
    we_prewalk: int = 0             # >0: walk the LM only for the top-N
                                    # word ends ranked by a static
                                    # unigram estimate; 0 = walk all
    split_multiwords: bool = False  # score multiwords ("give_me") as
                                    # their component sequence in the LM
                                    # (TokenPassSearch.cc:1818-1843)
    reentry_topk: int = 0           # top-K records per entry node (not
                                    # ported yet); 0 = full expansion
    word_end_beam: float = 0.0      # prune word ends vs the frame's best
                                    # word end (TokenPassSearch.cc:
                                    # 1076-1081); 0 = off
    reentry_prewalk: int = 0        # >0: each re-entering record keeps
                                    # its top-K entry nodes, ranked by
                                    # root arc + entry obs; 0 = all
    reentry_preselect: int = 0      # static top-P re-entry rows (not
                                    # ported yet); 0 = the full row
    reentry_records: int = 0        # >0: only the best K record slots
                                    # re-enter (all E are written)
    # pruning extensions (Toolbox.hh:182-221, not ported yet); 0 = off
    eq_depth_beam: float = 0.0
    eq_word_count_beam: float = 0.0
    fan_in_beam: float = 0.0
    fan_out_beam: float = 0.0
    tp_state_beam: float = 0.0

    @property
    def lm_scale_eff(self) -> float:
        return self.lm_scale / LN10

    @property
    def transition_scale_eff(self) -> float:
        return self.transition_scale / LN10

    @property
    def insertion_penalty_eff(self) -> float:
        return self.insertion_penalty * LN10


def expand_word_boundaries(words: list, cfg) -> list:
    """Morph mode: a mid-utterance sentence-end commit restarts the LM
    history through <s> + the word boundary (TokenPassSearch.cc:903-919);
    the reference prints those entries, so mirror them."""
    if not cfg.word_boundary:
        return words
    out = []
    for w in words:
        out.append(w)
        if w == cfg.sentence_end:
            out.append("<s>")
            out.append(cfg.word_boundary)
    return out


def multiword_components(lm_names, lm, split: bool):
    """Per tree word: component LM-word ids and names.

    Returns (comp [V, Cmax] int32 padded with -1, lm_id [V] int32 — the
    first component's id, or -1 when any component is missing from the
    LM (such words are pruned, `TokenPassSearch.cc:846-862`), first_names,
    last_names — the component names for lookahead: subtree values use
    the first component, context rows the last (TokenPassSearch.cc:1872)).
    With split=False every word is its own single component (Cmax == 1).
    Words starting with '_' are silences, never split
    (TokenPassSearch.cc:1688-1691).
    """
    parts_of = []
    for w in lm_names:
        if split and not w.startswith("_") and "_" in w:
            ps = [p for p in w.split("_") if p]
            parts_of.append(ps if ps else [w])
        else:
            parts_of.append([w])
    cmax = max((len(p) for p in parts_of), default=1)
    V = max(len(lm_names), 1)
    comp = np.full((V, cmax), -1, np.int32)
    lm_id = np.full((V,), -1, np.int32)
    for i, ps in enumerate(parts_of):
        ids = [lm.word_index.get(p, -1) for p in ps]
        comp[i, :len(ids)] = ids
        lm_id[i] = ids[0] if all(x >= 0 for x in ids) else -1
    first = [ps[0] for ps in parts_of] or [""]
    last = [ps[-1] for ps in parts_of] or [""]
    return comp, lm_id, first, last


def walk_components(walk_fn, states, comp_ids):
    """Compose the LM walk over multiword components: walk_fn is
    (states [...], word [...]) -> (next [...], score); comp_ids is
    [..., Cmax] with -1 padding (identity)."""
    st = states
    sc = None
    for c in range(comp_ids.shape[-1]):
        wc = comp_ids[..., c]
        ok = wc >= 0
        nst, s = walk_fn(st, wc.clamp(min=0))
        st = torch.where(ok, nst, st)
        s = torch.where(ok, s, torch.zeros_like(s))
        sc = s if sc is None else sc + s
    return st, sc


def tree_dfs_intervals(tree):
    """Preorder DFS intervals over the prefix tree: subtree(n) spans
    positions [lo[n], hi[n]).  Children are explored in ascending node
    id so HMM skip arcs nest (next-state before skip-target); arcs that
    still violate containment (short-silence bridges, cross-word fan-in)
    widen the source interval — an admissible overestimate.
    """
    N = tree.num_nodes
    at = np.asarray(tree.arc_tgt)
    alp = np.asarray(tree.arc_logp)
    live = (alp > LOG_ZERO / 2) & (at != np.arange(N)[:, None])
    children = [sorted(set(int(x) for x in at[n][live[n]]))
                for n in range(N)]
    roots = np.unique(np.asarray(tree.root_pair_tgt)[
        np.asarray(tree.root_pair_logp) > LOG_ZERO / 2])
    lo = np.full(N, -1, np.int32)
    hi = np.zeros(N, np.int32)
    counter = 0
    for r in sorted(int(x) for x in roots):
        if lo[r] >= 0:
            continue
        # iterative preorder DFS with post-visit hi assignment
        stack = [(r, iter(children[r]))]
        lo[r] = counter
        counter += 1
        while stack:
            n, it = stack[-1]
            for m in it:
                if lo[m] < 0:
                    lo[m] = counter
                    counter += 1
                    stack.append((m, iter(children[m])))
                    break
            else:
                hi[n] = counter
                stack.pop()
    # unvisited nodes: empty intervals
    unv = lo < 0
    lo[unv] = 0
    hi[unv] = 0
    # widen to a containment fixpoint: widening only adds words to a
    # subtree claim, which loosens the lookahead bound (admissible)
    srcs, slots = np.nonzero(live)
    tgts = at[srcs, slots]
    for _ in range(N):
        need = (lo[srcs] > lo[tgts]) | (hi[tgts] > hi[srcs])
        if not need.any():
            break
        np.minimum.at(lo, srcs[need], lo[tgts[need]])
        np.maximum.at(hi, srcs[need], hi[tgts[need]])
    return lo, hi


def unigram_lookahead(tree: PrefixTree, lm: NGramFsa,
                      lm_names: list) -> np.ndarray:
    """[N] per-node lookahead scores: the best unigram LM log-prob over
    the words completing at or below each node (a bottom-up max over the
    static tree, so lookahead at decode time is one gather; the
    reference's per-node word lists, `TPLexPrefixTree.hh`).  Words that
    bypass the LM (we_skip / silence) contribute 0 (admissible)."""
    V = lm.num_words
    uni = np.full(V, -np.inf, dtype=np.float64)
    lo, hi = int(lm.state_first[0]), int(lm.state_first[1])
    uni[lm.trans_word[lo:hi]] = lm.trans_prob[lo:hi]
    word_uni = np.array(
        [uni[lm.word_index[w]] if w in lm.word_index else -np.inf
         for w in lm_names] or [-np.inf])

    valid_we = tree.we_exit_logp > LOG_ZERO / 2
    w = np.maximum(tree.we_word, 0)
    contrib = np.where(tree.we_skip_lm, 0.0, word_uni[w])
    contrib = np.where(valid_we & (tree.we_word >= 0), contrib,
                       np.where(valid_we, 0.0, -np.inf))
    la = contrib.max(axis=1)                     # [N] local word ends

    not_self = ((tree.arc_tgt != np.arange(tree.num_nodes)[:, None])
                & (tree.arc_logp > LOG_ZERO / 2))
    tgt = np.maximum(tree.arc_tgt, 0)
    for _ in range(tree.num_nodes):
        child = np.where(not_self, la[tgt], -np.inf).max(axis=1)
        new = np.maximum(la, child)
        if np.array_equal(new, la):
            break
        la = new
    return np.where(np.isfinite(la), la, 0.0).astype(np.float32)


def bigram_lookahead(tree: PrefixTree, lm: NGramFsa,
                     lm_names: list) -> np.ndarray:
    """[V+1, N] bigram lookahead table: row w = best P(v|w) over the
    words v completing at or below each node; the last row is the
    unigram (no-context) fallback used before the first word.  The
    reference computes these lazily per (history, node) with a cache
    (TokenPassSearch.cc get_lm_bigram_lookahead)."""
    V = lm.num_words
    uni = np.full(V, -np.inf)
    lo, hi = int(lm.state_first[0]), int(lm.state_first[1])
    uni[lm.trans_word[lo:hi]] = lm.trans_prob[lo:hi]

    # dense backoff bigram matrix B[w, v] = P(v | w)
    B = np.zeros((V + 1, V))
    bo = np.zeros(V)
    ctx_state = np.full(V, -1, dtype=np.int64)
    for ctx, st in lm.state_of_context.items():
        if len(ctx) == 1:
            ctx_state[ctx[0]] = st
    has_ctx = ctx_state >= 0
    bo[has_ctx] = lm.bo_weight[ctx_state[has_ctx]]
    B[:V] = bo[:, None] + uni[None, :]
    for w in np.nonzero(has_ctx)[0]:
        a, b = (int(lm.state_first[ctx_state[w]]),
                int(lm.state_first[ctx_state[w] + 1]))
        B[w, lm.trans_word[a:b]] = lm.trans_prob[a:b]
    B[V] = uni                              # no-context fallback row

    word_lm = np.array(
        [lm.word_index.get(w, -1) for w in lm_names] or [-1])

    valid_we = tree.we_exit_logp > LOG_ZERO / 2
    N = tree.num_nodes
    la = np.full((V + 1, N), -np.inf)
    for n in range(N):
        for h in np.nonzero(valid_we[n])[0]:
            w = tree.we_word[n, h]
            if tree.we_skip_lm[n, h] or w < 0:
                la[:, n] = np.maximum(la[:, n], 0.0)
            elif word_lm[w] >= 0:
                la[:, n] = np.maximum(la[:, n], B[:, word_lm[w]])

    not_self = ((tree.arc_tgt != np.arange(N)[:, None])
                & (tree.arc_logp > LOG_ZERO / 2))
    tgt = np.maximum(tree.arc_tgt, 0)
    for _ in range(N):
        child = np.where(not_self[None, :, :], la[:, tgt], -np.inf
                         ).max(axis=2)
        new = np.maximum(la, child)
        if np.array_equal(new, la):
            break
        la = new
    return np.where(np.isfinite(la), la, 0.0).astype(np.float32)


def top_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest values along the last axis, ties broken
    by lower index (the order `jax.lax.top_k` gives; `torch.topk`
    promises none)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b, ...]] for a batched x [B, M]."""
    return x.gather(1, idx.reshape(idx.shape[0], -1)).reshape(idx.shape)


class _RowTable:
    """Named column blocks of one [N, C] device table, so a token's
    per-node values come with one row gather."""

    def __init__(self, blocks: dict, dtype, device):
        cols, self.slices, c = [], {}, 0
        for name, a in blocks.items():
            a = np.asarray(a)
            width = 1 if a.ndim == 1 else a.shape[1]
            self.slices[name] = (c, width, a.ndim == 1)
            cols.append(a.reshape(a.shape[0], width).astype(dtype))
            c += width
        self.table = torch.as_tensor(np.concatenate(cols, axis=1),
                                     device=device)

    def rows(self, node: torch.Tensor) -> dict:
        got = self.table[node]
        return {k: got[..., s] if flat else got[..., s:s + w]
                for k, (s, w, flat) in self.slices.items()}


class BeamSearch:
    """The exact batched decoder for one (tree, LM, model) triple, on
    ``device``: the GPU unless the caller passes ``device="cpu"``."""

    def __init__(self, tree: PrefixTree, lm: NGramFsa, model,
                 config: SearchConfig = SearchConfig(),
                 lookahead_lm: NGramFsa | None = None,
                 device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        _refuse_unported(config, lm)
        self.tree = tree
        self.lm = lm
        self.config = config
        N = tree.num_nodes
        # tree word id -> LM word id; words absent from the LM (or with
        # a missing multiword component) are pruned
        mw_comp, lm_id, la_first, la_last = multiword_components(
            tree.vocab, lm, config.split_multiwords)
        self._mw_cmax = mw_comp.shape[1]
        we_word = np.asarray(tree.we_word, np.int64)
        we_lmid = np.where(we_word >= 0, lm_id[np.maximum(we_word, 0)], -1)
        pdf = np.asarray(tree.pdf, np.int64)

        # committed-at-final base validity: a token resting on a node
        # whose only role is ending words (non-skip word ends, no
        # continuation arc, no skip/silence end) has no uncommitted
        # interpretation in the reference (word ids live on dedicated
        # word-end nodes there)
        has_arc = ((tree.arc_tgt != np.arange(N)[:, None])
                   & (tree.arc_logp > LOG_ZERO / 2)).any(axis=1)
        valid_we = tree.we_exit_logp > LOG_ZERO / 2
        nonskip_we = (valid_we & (tree.we_word >= 0)
                      & ~tree.we_skip_lm).any(axis=1)
        skip_we = (valid_we & ((tree.we_word < 0)
                               | tree.we_skip_lm)).any(axis=1)
        fin_base_ok = has_arc | ~nonskip_we | skip_we

        # morph word boundary: the double-boundary prune and the </s>
        # reset state (<s> then the boundary word, scores discarded)
        self._wb_tid = (tree.word_index.get(config.word_boundary, -1)
                        if config.word_boundary else -1)
        self._end_tid = tree.word_index.get(config.sentence_end, -1)
        is_wb_state = None
        if self._wb_tid >= 0:
            wbl = lm.word_index.get(config.word_boundary, -1)
            is_wb_state = (lm.states_ending_with(wbl) if wbl >= 0
                           else np.zeros(lm.num_states, bool))
            st = lm.initial_state()
            if wbl >= 0:
                st, _ = lm.walk(st, wbl)
            self._wb_reset = int(st)

        # static per-word unigram estimate for the we_prewalk ranking
        uni_row = np.full(lm.num_words + 1, -30.0, np.float32)
        lo0, hi0 = int(lm.state_first[0]), int(lm.state_first[1])
        uni_row[lm.trans_word[lo0:hi0]] = lm.trans_prob[lo0:hi0]
        uni_est = np.where(lm_id >= 0, uni_row[np.maximum(lm_id, 0)],
                           0.0).astype(np.float32)
        self._has_durations = bool(np.any(duration_table(
            model, config.max_dur, config.duration_scale) != 0))

        # in-word arcs: every arc slot, or (overflow_tokens) the first
        # three live arcs per node, self-loop first, with the rare extra
        # fan-out in compact overflow rows
        at = np.asarray(tree.arc_tgt)
        alp = np.asarray(tree.arc_logp)
        if config.overflow_tokens:
            arc_tgt, arc_lp, o_tgt, o_lp, over_map = _split_arcs(at, alp)
            self._num_over_rows = o_tgt.shape[0] - 1
        else:
            arc_tgt, arc_lp = at, alp

        # lookahead (ranking and pruning only; stored scores stay pure)
        self._la_on = bool(config.lm_lookahead)
        self._la_bigram = False
        self._la_init_row = 0
        la_lm = lookahead_lm or lm
        we_law = None
        if self._la_on:
            V = la_lm.num_words
            if (config.lm_lookahead >= 2
                    and (V + 1) * N * 4 <= 512_000_000):
                self._la_bigram = True
                la2 = bigram_lookahead(tree, la_lm, la_first)
                # tree word id -> lookahead-LM row (V = no-context row);
                # a multiword's context is its last component
                la_wid = np.asarray([la_lm.word_index.get(w, V)
                                     for w in la_last] or [V], np.int64)
                we_law = np.where(we_word >= 0,
                                  la_wid[np.maximum(we_word, 0)], V)
                self._la_init_row = la_lm.word_index.get("<s>", V)
                self._V_la = V
            else:
                if config.lm_lookahead >= 2:
                    import sys
                    print("BeamSearch: bigram lookahead table over "
                          "budget; falling back to unigram",
                          file=sys.stderr)
                la1 = unigram_lookahead(tree, la_lm, la_first)

        def dev(a, dtype=None):
            return torch.as_tensor(np.asarray(a), dtype=dtype,
                                   device=self.device)

        i64 = torch.int64
        # per-node step tables: one int64 and one float32 row per token
        ints = {"arc_tgt": arc_tgt, "arc_pdf": pdf[np.maximum(arc_tgt, 0)],
                "we_word": we_word, "we_skip": tree.we_skip_lm,
                "we_lmid": we_lmid, "we_pair": tree.we_pair}
        flts = {"arc_lp": arc_lp, "we_exit": tree.we_exit_logp,
                "we_pron": tree.we_pron_logp,
                "we_uni": np.where(we_word >= 0,
                                   uni_est[np.maximum(we_word, 0)], 0.0)}
        if config.overflow_tokens:
            ints["over_map"] = over_map
        if we_law is not None:
            ints["we_law"] = we_law
        if self._has_durations:
            flts.update(node_duration_params(tree, model,
                                             config.duration_scale))
        self._rows_i = _RowTable(ints, np.int64, self.device)
        self._rows_f = _RowTable(flts, np.float32, self.device)

        t = {"pdf": dev(pdf, i64), "fin_base_ok": dev(fin_base_ok),
             "mw_comp": dev(mw_comp, i64),
             "root_tgt": dev(tree.root_pair_tgt, i64),
             "root_logp": dev(tree.root_pair_logp),
             "root_pdf": dev(pdf[np.maximum(tree.root_pair_tgt, 0)], i64),
             "we_word": dev(we_word, i64), "we_lmid": dev(we_lmid, i64),
             "we_exit": dev(tree.we_exit_logp),
             "we_pron": dev(tree.we_pron_logp),
             "we_skip": dev(tree.we_skip_lm)}
        if config.overflow_tokens:
            t.update({"over_tgt": dev(o_tgt, i64), "over_lp": dev(o_lp),
                      "over_pdf": dev(pdf[o_tgt], i64)})
        if is_wb_state is not None:
            t["is_wb_state"] = dev(is_wb_state)
        if self._la_bigram:
            t["la2"] = dev(la2).reshape(-1)        # [(V+1) * N]
        elif self._la_on:
            t["la"] = dev(la1)
        self.t = t
        self.lm_tables = lm.device_tables(self.device)

    # -- pieces of the step -------------------------------------------------
    def _walk(self, states, word):
        return lm_walk_device(self.lm_tables, self.lm.order, states, word)

    def _mw_walk(self, states, words, lmids):
        """LM walk of tree words (their LM ids, or their components)."""
        if self._mw_cmax == 1:
            return self._walk(states, lmids.clamp(min=0))
        return walk_components(self._walk, states,
                               self.t["mw_comp"][words.clamp(min=0)])

    def _expand(self, src, a_tgt, a_lp, durb, allow_self):
        """Candidates along the arcs [B, K, A] of the selected tokens
        ``src`` (their fields, each [B, K]), flattened to [B, K*A]."""
        node, lm, am, lms, dur, rec, alive, law = src
        shape = a_tgt.shape
        B = shape[0]
        if allow_self:
            is_self = a_tgt == node[..., None]
            durp = torch.where(is_self, 0.0, durb[..., None])
            c_dur = torch.where(is_self, dur[..., None] + 1, 0)
        else:
            durp = durb[..., None]
            c_dur = torch.zeros(shape, dtype=dur.dtype, device=dur.device)
        c = {"node": a_tgt,
             "lm": lm[..., None].expand(shape),
             "am": am[..., None] + self.config.transition_scale_eff * a_lp
             + durp,
             "lms": lms[..., None].expand(shape),
             "dur": c_dur,
             "rec": rec[..., None].expand(shape),
             "alive": alive[..., None] & (a_lp > LOG_ZERO / 2),
             "law": law[..., None].expand(shape)}
        return {k: v.reshape(B, -1) for k, v in c.items()}

    def _step(self, tok, obs_t, step_idx: int):
        """One frame for [B, W] tokens (node, lm, am, lms, dur, rec,
        alive, law); obs_t is the frame's [B, S] log-probs.  Returns the
        new tokens and this frame's [B, E] records (word, previous
        record, am, lms)."""
        cfg = self.config
        t = self.t
        node, lmst, am, lms, dur, rec, alive, law = tok
        B, W = node.shape
        E = cfg.num_records
        H = self.tree.we_word.shape[1]
        ls = cfg.lm_scale_eff
        ts = cfg.transition_scale_eff
        ins = cfg.insertion_penalty_eff
        dvc = node.device
        ri = self._rows_i.rows(node)
        rf = self._rows_f.rows(node)
        if self._has_durations:
            d_ = torch.clamp(dur + 1, 1, cfg.max_dur).float()
            durb = rf["dur_valid"] * (rf["dur_lncoef"] * torch.log(d_)
                                      - d_ * rf["dur_invb"]
                                      + rf["dur_const"])
        else:
            durb = torch.zeros_like(am)

        # ---- 1. in-word expansion (+ branch arcs of the top-O tokens)
        groups = [self._expand(tok, ri["arc_tgt"], rf["arc_lp"], durb,
                               True)]
        groups[0]["am"] = groups[0]["am"] + _take(
            obs_t, ri["arc_pdf"]).reshape(B, -1)
        if cfg.overflow_tokens:
            O = min(cfg.overflow_tokens, W)
            orow = ri["over_map"]
            is_branch = alive & (orow < self._num_over_rows)
            rank = torch.where(is_branch, am + ls * lms, NEG_INF)
            sel_o = top_k(rank, O)                       # [B, O]
            o_row = orow.gather(1, sel_o)
            src = tuple(x.gather(1, sel_o) for x in tok)
            c1b = self._expand(src, t["over_tgt"][o_row],
                               t["over_lp"][o_row], durb.gather(1, sel_o),
                               False)
            c1b["am"] = c1b["am"] + _take(
                obs_t, t["over_pdf"][o_row]).reshape(B, -1)
            Ao = t["over_tgt"].shape[1]
            c1b["alive"] = c1b["alive"] & is_branch.gather(
                1, sel_o)[..., None].expand(B, O, Ao).reshape(B, -1)
            groups.append(c1b)

        # ---- 2. word ends [W, H] -> (prewalk top-E2) -> LM walk ->
        #         records [E] -> context rows [Er, R]
        w_word = ri["we_word"]
        w_exit = rf["we_exit"]
        w_lmid = ri["we_lmid"]
        skip = (ri["we_skip"] != 0) | (w_word < 0)
        w_alive = alive[..., None] & (w_exit > LOG_ZERO / 2)
        # words missing from the LM are pruned (lm_id < 0)
        w_alive = w_alive & (skip | (w_lmid >= 0))
        we_am = am[..., None] + ts * w_exit + durb[..., None]
        base_lms = lms[..., None] + rf["we_pron"] + torch.where(
            skip, 0.0, ins)
        if self._la_bigram:
            # next lookahead row: the committed word, or the previous
            # row across silences and words outside the lookahead LM
            wid = ri["we_law"]
            w_law = torch.where(wid < self._V_la, wid, law[..., None])
        else:
            w_law = law[..., None].expand(B, W, H)
        WH = W * H
        E2 = min(cfg.we_prewalk, WH) if cfg.we_prewalk else WH
        E2 = max(E2, E)
        if E2 < WH:
            # rank word ends by a static unigram LM estimate; the exact
            # walk runs on the top E2
            pre = we_am + ls * (base_lms
                                + torch.where(skip, 0.0, rf["we_uni"]))
            ord2 = top_k(torch.where(w_alive, pre, NEG_INF).reshape(B, WH),
                         E2)

            def pick(x):
                return x.reshape(B, WH).gather(1, ord2)

            s_prev = rec.gather(1, ord2 // H)
            s_state = lmst.gather(1, ord2 // H)
        else:
            E2 = WH

            def pick(x):
                return x.reshape(B, WH)

            s_prev = pick(rec[..., None].expand(B, W, H))
            s_state = pick(lmst[..., None].expand(B, W, H))
        s_word, s_am, s_base, s_skip = (pick(w_word), pick(we_am),
                                        pick(base_lms), pick(skip))
        s_alive, s_pair, s_law = (pick(w_alive), pick(ri["we_pair"]),
                                  pick(w_law))
        lm_next, lm_score = self._mw_walk(s_state, s_word, pick(w_lmid))
        lm_next = torch.where(s_skip, s_state, lm_next)
        lm_score = torch.where(s_skip, 0.0, lm_score)
        we_lms2 = s_base + lm_score
        we_alive2 = s_alive & (lm_score > LOG_ZERO / 2)
        if self._wb_tid >= 0:
            # morph mode: prune two subsequent word boundaries, and a
            # mid-utterance sentence end restarts the LM through <s> +
            # boundary (TokenPassSearch.cc:869-873, 888-919)
            prev_wb = t["is_wb_state"][s_state]
            we_alive2 = we_alive2 & ~((s_word == self._wb_tid) & prev_wb)
            if self._end_tid >= 0:
                lm_next = torch.where(s_word == self._end_tid,
                                      self._wb_reset, lm_next)
        we_total2 = s_am + ls * we_lms2
        if cfg.word_end_beam:
            we_best = torch.where(we_alive2, we_total2, NEG_INF).max(
                dim=1, keepdim=True).values
            we_alive2 = we_alive2 & (we_total2
                                     >= we_best - cfg.word_end_beam)

        # the E best word ends become this frame's records (a pool
        # smaller than E leaves the remaining slots dead)
        k = min(E, E2)
        order = top_k(torch.where(we_alive2, we_total2, NEG_INF), k)
        e_alive = we_alive2.gather(1, order)
        if k < E:
            order = torch.cat([order, torch.zeros(
                (B, E - k), dtype=order.dtype, device=dvc)], dim=1)
            e_alive = torch.cat([e_alive, torch.zeros(
                (B, E - k), dtype=torch.bool, device=dvc)], dim=1)
        e_word, e_prev, e_lm, e_am, e_lms, e_pair, e_law = (
            x.gather(1, order) for x in (s_word, s_prev, lm_next, s_am,
                                         we_lms2, s_pair, s_law))
        # silence (word < 0) keeps its previous record pointer; pointers
        # are step_idx * E + slot
        is_word = e_alive & (e_word >= 0)
        rec_word = torch.where(e_alive, e_word, -1)
        rec_prev = torch.where(is_word, e_prev, -1)
        rec_am = torch.where(is_word, e_am, 0.0)
        rec_lms = torch.where(is_word, e_lms, 0.0)
        slot_ptr = step_idx * E + torch.arange(E, device=dvc)
        new_rec = torch.where(is_word, slot_ptr, e_prev)

        # re-entry: the best Er records (records are best-first) through
        # their context rows
        Er = min(cfg.reentry_records, E) if cfg.reentry_records else E
        e_alive, e_lm, e_am, e_lms, e_pair, e_law, re_rec = (
            x[:, :Er] for x in (e_alive, e_lm, e_am, e_lms, e_pair, e_law,
                                new_rec))
        r_tgt = t["root_tgt"][e_pair]                  # [B, Er, R]
        r_lp = t["root_logp"][e_pair]
        obs2 = _take(obs_t, t["root_pdf"][e_pair])
        R = r_tgt.shape[2]
        RK = min(cfg.reentry_prewalk, R) if cfg.reentry_prewalk else 0
        if RK and RK < R:
            # each record keeps its RK best entry nodes by root arc +
            # entry obs (the record's own score is constant in its row)
            rank2 = r_lp + obs2
            if self._la_on and not self._la_bigram:
                rank2 = rank2 + ls * t["la"][r_tgt]
            rank2 = torch.where(r_lp > LOG_ZERO / 2, rank2, NEG_INF)
            idxr = top_k(rank2, RK)                    # [B, Er, RK]
            r_tgt, r_lp, obs2 = (x.gather(2, idxr) for x in (r_tgt, r_lp,
                                                             obs2))
        shape = r_tgt.shape
        c2 = {"node": r_tgt,
              "lm": e_lm[..., None].expand(shape),
              "am": e_am[..., None] + r_lp + obs2,
              "lms": e_lms[..., None].expand(shape),
              "dur": torch.zeros(shape, dtype=dur.dtype, device=dvc),
              "rec": re_rec[..., None].expand(shape),
              "alive": e_alive[..., None] & (r_lp > LOG_ZERO / 2),
              "law": e_law[..., None].expand(shape)}
        groups.append({k2: v.reshape(B, -1) for k2, v in c2.items()})
        cand = {k2: torch.cat([g[k2] for g in groups], dim=1)
                for k2 in groups[0]}

        # ---- 3. global beam, recombination, top-W
        total = cand["am"] + ls * cand["lms"]
        if self._la_bigram:
            total = total + ls * t["la2"][cand["law"] * self.tree.num_nodes
                                          + cand["node"]]
        elif self._la_on:
            total = total + ls * t["la"][cand["node"]]
        c_alive = cand["alive"]
        total = torch.where(c_alive, total, NEG_INF)
        best = total.max(dim=1, keepdim=True).values
        c_alive = c_alive & (total >= best - cfg.beam)
        sel, new_alive = recombine(cand["node"], cand["lm"], total, c_alive,
                                   self.lm.num_states, W)
        new_tok = tuple(cand[k2].gather(1, sel) for k2 in
                        ("node", "lm", "am", "lms", "dur", "rec"))
        new_tok = new_tok + (new_alive, cand["law"].gather(1, sel))
        return new_tok, (rec_word, rec_prev, rec_am, rec_lms)

    def _seed_tokens(self, obs0, lm_init: int):
        """Utterance-initial tokens [B, W] from the initial context row.
        A row wider than W keeps its top-W entries by entry logp +
        frame-0 obs: the per-frame recombination beam at frame 0 (row
        entries are distinct nodes, one candidate each).  On cross-word
        trees every live entry logp is 0, so am is the obs itself."""
        W = self.config.num_tokens
        B = obs0.shape[0]
        dvc = obs0.device
        init_tgt = self.t["root_tgt"][self.tree.init_pair]
        init_lp = self.t["root_logp"][self.tree.init_pair]
        R = init_tgt.shape[0]
        if R <= W:
            node0 = torch.zeros(W, dtype=torch.int64, device=dvc)
            node0[:R] = init_tgt
            alive0 = torch.zeros(W, dtype=torch.bool, device=dvc)
            alive0[:R] = init_lp > LOG_ZERO / 2
            node0, alive0 = node0.expand(B, W), alive0.expand(B, W)
            am0 = torch.where(alive0, obs0[:, self.t["pdf"][node0[0]]],
                              LOG_ZERO)
        else:
            obs_r = obs0[:, self.t["root_pdf"][self.tree.init_pair]]
            score = torch.where(init_lp > LOG_ZERO / 2, init_lp + obs_r,
                                NEG_INF)
            topi = top_k(score, W)
            node0 = init_tgt[topi]
            alive0 = score.gather(1, topi) > LOG_ZERO / 2
            am0 = torch.where(alive0, obs_r.gather(1, topi), LOG_ZERO)

        def full(v, dtype):
            return torch.full((B, W), v, dtype=dtype, device=dvc)

        return (node0.contiguous(), full(lm_init, torch.int64), am0,
                full(0.0, torch.float32), full(0, torch.int64),
                full(-1, torch.int64), alive0.contiguous(),
                full(self._la_init_row, torch.int64))

    def _final_commit(self, node, lmst, lms, end_id):
        """Best committed interpretation per final token: each word end
        on the token's node pays pron + insertion + LM walk (+ the
        required sentence end from the post-commit state) with no exit
        transition or duration.  Returns (word [B, W], lms [B, W]); word
        -1 where the node has no usable word end."""
        cfg = self.config
        t = self.t
        wW = t["we_word"][node]                        # [B, W, H]
        ok = ((t["we_exit"][node] > LOG_ZERO / 2) & ~t["we_skip"][node]
              & (wW >= 0))
        lmid = t["we_lmid"][node]
        ok = ok & (lmid >= 0)
        st = lmst[..., None].expand(wW.shape)
        nxt, sc = self._mw_walk(st, wW, lmid)
        if self._wb_tid >= 0:
            ok = ok & ~((wW == self._wb_tid) & t["is_wb_state"][st])
            if self._end_tid >= 0:
                nxt = torch.where(wW == self._end_tid, self._wb_reset, nxt)
        if end_id is not None:
            _, end2 = self._walk(nxt, torch.full_like(nxt, end_id))
        else:
            end2 = torch.zeros_like(sc)
        alt = (lms[..., None] + t["we_pron"][node] + cfg.insertion_penalty_eff
               + (sc + end2))
        alt = torch.where(ok & (sc > LOG_ZERO / 2), alt, NEG_INF)
        h_best = alt.argmax(dim=2, keepdim=True)
        alt_lms = alt.gather(2, h_best)[..., 0]
        alt_w = torch.where(torch.isfinite(alt_lms),
                            wW.gather(2, h_best)[..., 0], -1)
        return alt_w, alt_lms

    def _finalize(self, tok):
        """The best final token per utterance -> (record pointer, total,
        am, lms, word committed at the final frame or -1), each [B]."""
        cfg = self.config
        ls = cfg.lm_scale_eff
        node, lmst, am, lms, dur, rec, alive, law = tok
        end_id = (self.lm.word_index.get(cfg.sentence_end)
                  if cfg.require_sentence_end else None)
        if end_id is not None:
            _, end_sc = self._walk(lmst, torch.full_like(lmst, end_id))
            base_lms = lms + torch.where(alive, end_sc, 0.0)
            # committed-at-final alternative: a token that reached a
            # word's last state by the final frame is committed there in
            # the reference (fin_base_ok says whether the uncommitted
            # interpretation exists too); the commit pays pron + LM +
            # </s> but no exit transition or duration
            aw, alms = self._final_commit(node, lmst, lms, end_id)
            alt_total = torch.where(alive & (aw >= 0), am + ls * alms,
                                    NEG_INF)
            base_total = torch.where(alive & self.t["fin_base_ok"][node],
                                     am + ls * base_lms, NEG_INF)
            use_alt = alt_total > base_total
            total = torch.maximum(base_total, alt_total)
            lms = torch.where(use_alt, alms, base_lms)
            fin_w = torch.where(use_alt, aw, -1)
        else:
            total = torch.where(alive, am + ls * lms, NEG_INF)
            fin_w = torch.full_like(node, -1)
        best = total.argmax(dim=1, keepdim=True)
        return tuple(x.gather(1, best)[:, 0]
                     for x in (rec, total, am, lms, fin_w))

    def _decode(self, obs, n_frames: np.ndarray, lm_init: int,
                lattice: bool):
        """[B, T, S] obs on the device, host frame counts [B] -> the
        finals of `_finalize` and the [B, T-1, E] records: (word,
        previous record) or, with ``lattice``, (word, previous, am, lms)."""
        B, T, _ = obs.shape
        tok = self._seed_tokens(obs[:, 0], lm_init)
        n_dev = torch.as_tensor(n_frames, device=obs.device)
        fills = (-1, -1, 0.0, 0.0)
        keep = 4 if lattice else 2
        recs = [[] for _ in range(keep)]
        for i in range(T - 1):
            new_tok, rows = self._step(tok, obs[:, i + 1], i)
            if (i + 1 < n_frames).all():   # host counts: no device sync
                tok = new_tok
            else:
                v = (i + 1 < n_dev)[:, None]
                tok = tuple(torch.where(v, a, b) for a, b in zip(new_tok, tok))
                rows = tuple(torch.where(v, r, f) for r, f in zip(rows, fills))
            for lst, r in zip(recs, rows):
                lst.append(r)
        finals = self._finalize(tok)
        E = self.config.num_records
        stacked = [torch.stack(lst, dim=1) if lst else
                   torch.full((B, 0, E), f, device=obs.device,
                              dtype=torch.int64 if j < 2 else torch.float32)
                   for j, (lst, f) in enumerate(zip(recs, fills))]
        return finals, stacked

    # -- public API ---------------------------------------------------------
    def decode(self, obs, n_frames: int | None = None,
               sentence_start: str = "<s>",
               lattice: bool = True) -> "DecodeResult":
        """Decode one utterance: [T, S] state log-likelihoods -> result
        (iterable as (words, log_prob)).  With lattice=True it carries
        the records; lattice=False fetches only what the 1-best needs."""
        obs = torch.as_tensor(obs, dtype=torch.float32, device=self.device)
        if n_frames is None:
            n_frames = obs.shape[0]
        return self.decode_batch(obs[None], [n_frames], sentence_start,
                                 lattice=lattice)[0]

    def decode_batch(self, obs, n_frames, sentence_start: str = "<s>",
                     lattice: bool = True) -> list:
        """[B, T, S] state log-probs + [B] frame counts -> B results."""
        obs = torch.as_tensor(obs, dtype=torch.float32, device=self.device)
        n = np.asarray(torch.as_tensor(n_frames).cpu(), np.int64)
        lm_init = int(self.lm.initial_state(sentence_start))
        finals, recs = self._decode(obs, n, lm_init, lattice)
        finals, recs = [[x.cpu().numpy() for x in xs]
                        for xs in (finals, recs)]
        ptr, total, am, lms, fin_w = finals
        out = []
        for b in range(obs.shape[0]):
            if lattice:
                out.append(DecodeResult(
                    search=self, final_ptr=int(ptr[b]),
                    log_prob=float(total[b]), final_am=float(am[b]),
                    final_lms=float(lms[b]), rec_words=recs[0][b],
                    rec_prevs=recs[1][b], rec_ams=recs[2][b],
                    rec_lmss=recs[3][b], final_word=int(fin_w[b])))
                continue
            ids = traceback(recs[0][b], recs[1][b], int(ptr[b]),
                            int(fin_w[b]), obs.shape[1])
            out.append(DecodeResult(
                search=self, final_ptr=int(ptr[b]),
                log_prob=float(total[b]), final_am=float(am[b]),
                final_lms=float(lms[b]), rec_words=None, rec_prevs=None,
                rec_ams=None, rec_lmss=None,
                words=expand_word_boundaries(
                    [self.tree.vocab[i] for i in ids], self.config)))
        return out


def recombine(node, lm, total, alive, num_states: int, W: int):
    """Recombination and the top-W cut of [B, C] candidates: the first
    live candidate per (node, LM state) in (node, state, -total, index)
    order survives, and the W best survivors by total (ties in (node,
    state) order) become the tokens.  Returns (sel [B, W] candidate
    rows, alive [B, W]).

    The reference sorts (node, state, -total) lexicographically in one
    stable sort; here a stable sort by -total, then a stable sort by the
    int64 key node * num_states + state, give the same order.  -0.0 and
    0.0 compare equal in both, as the reference canonicalizes zeros.
    """
    B = node.shape[0]
    neg_total = torch.where(alive, -total, POS_INF)
    key = torch.where(alive, node * num_states + lm, DEAD_KEY)
    p1 = torch.sort(neg_total, dim=1, stable=True).indices
    s_key, p2 = torch.sort(key.gather(1, p1), dim=1, stable=True)
    s_idx = p1.gather(1, p2)
    first = torch.cat([torch.ones((B, 1), dtype=torch.bool,
                                  device=node.device),
                       s_key[:, 1:] != s_key[:, :-1]], dim=1)
    s_alive = first & (s_key != DEAD_KEY)
    neg2 = torch.where(s_alive, neg_total.gather(1, s_idx), POS_INF)
    v2, p3 = torch.sort(neg2, dim=1, stable=True)
    return s_idx.gather(1, p3[:, :W]), v2[:, :W] < POS_INF


def traceback(rec_words, rec_prevs, ptr: int, final_word: int,
              cap: int) -> list:
    """Word ids of the 1-best chain, oldest first: the records [F, E]
    from pointer ``ptr`` back, then the word committed at the final
    frame (>= 0), at most ``cap`` words (one commits per frame at most)."""
    flat_w = rec_words.reshape(-1)
    flat_p = rec_prevs.reshape(-1)
    ids = [final_word] if final_word >= 0 else []
    while ptr >= 0 and len(ids) < cap:
        ids.append(int(flat_w[ptr]))
        ptr = int(flat_p[ptr])
    return [i for i in reversed(ids) if i >= 0]


def _split_arcs(at, alp):
    """(tgt3, lp3 [N, 3], over_tgt, over_lp [Ko + 1, Ao], over_map [N]):
    each node's first three live arcs, self-loop first (dense slot 0 is
    the duration hold), and the rest in compact overflow rows; nodes
    without overflow map to the dead row Ko."""
    N, A = at.shape
    live = alp > LOG_ZERO / 2
    tgt3 = np.zeros((N, 3), np.int64)
    lp3 = np.full((N, 3), LOG_ZERO, np.float32)
    over_map = np.full(N, -1, np.int64)
    over = []
    for n in range(N):
        arcs = [(int(at[n, a]), float(alp[n, a])) for a in range(A)
                if live[n, a]]
        arcs.sort(key=lambda x: (x[0] != n,))
        for j, (tg, lp) in enumerate(arcs[:3]):
            tgt3[n, j] = tg
            lp3[n, j] = lp
        if len(arcs) > 3:
            over_map[n] = len(over)
            over.append(arcs[3:])
    Ko = len(over)
    Ao = max((len(a) for a in over), default=1)
    o_tgt = np.zeros((Ko + 1, Ao), np.int64)
    o_lp = np.full((Ko + 1, Ao), LOG_ZERO, np.float32)
    for r, arcs in enumerate(over):
        for j, (tg, lp) in enumerate(arcs):
            o_tgt[r, j] = tg
            o_lp[r, j] = lp
    over_map[over_map < 0] = Ko
    return tgt3, lp3, o_tgt, o_lp, over_map


def _refuse_unported(config: SearchConfig, lm) -> None:
    """Raise for the options not ported yet, before any table is
    built (never mid-decode)."""
    if not isinstance(lm, NGramFsa):
        raise NotImplementedError(
            "interpolated LMs (InterNGramFsa) are not ported yet "
            f"({EXACT_REST_ITEM})")
    if config.lm_lookahead >= 3:
        raise NotImplementedError(
            f"context lookahead (lm_lookahead 3) is not ported yet "
            f"({EXACT_REST_ITEM})")
    for name in ("reentry_topk", "reentry_preselect", "eq_depth_beam",
                 "eq_word_count_beam", "fan_in_beam", "fan_out_beam",
                 "tp_state_beam"):
        if getattr(config, name):
            raise NotImplementedError(
                f"{name} is not ported yet ({EXACT_REST_ITEM})")


class DecodeResult:
    """1-best plus the word records of one utterance (iterable as
    (words, log_prob))."""

    def __init__(self, search, final_ptr, log_prob, final_am, final_lms,
                 rec_words, rec_prevs, rec_ams, rec_lmss, words=None,
                 final_word=-1):
        self.search = search
        self._words = words
        self.final_word = final_word     # committed at the final frame
        self.final_ptr = final_ptr
        self.log_prob = log_prob
        self.final_am = final_am
        self.final_lms = final_lms
        self.rec_words = rec_words       # [T-1, E]
        self.rec_prevs = rec_prevs
        self.rec_ams = rec_ams
        self.rec_lmss = rec_lmss

    def __iter__(self):
        return iter((self.words, self.log_prob))

    def __getitem__(self, i):
        return (self.words, self.log_prob)[i]

    @property
    def words(self) -> list:
        """1-best word strings (given, or by the record chain)."""
        if self._words is not None:
            return self._words
        ids = traceback(self.rec_words, self.rec_prevs, self.final_ptr,
                        self.final_word, 100000)
        return expand_word_boundaries(
            [self.search.tree.vocab[i] for i in ids], self.search.config)

    def word_graph(self) -> WordGraph:
        """The lattice of the records (the word committed at the final
        frame is not an arc of it, as in the reference)."""
        if self.rec_words is None:
            raise RuntimeError(
                "decoded with lattice=False: records were not fetched")
        return WordGraph.from_records(
            self.search.tree.vocab, self.search.config,
            self.rec_words, self.rec_prevs, self.rec_ams, self.rec_lmss,
            self.final_ptr, self.final_am, self.final_lms)
