"""Search configuration, the exact token-passing engine and its results.

Counterpart of `aaltoasr_tpu/decoder/search.py` (the reference's
`decoder/src/TokenPassSearch.{hh,cc}`): `SearchConfig`, the morph-mode
word list expansion, the LM-lookahead tables, `BeamSearch`, the
record-carrying `DecodeResult` and the push-model `StreamingDecoder`.
The word-end commit rule and the record format are `wordend.py`'s.

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
- the one-hot membership products of ``reentry_topk``: boolean gathers
  of the factored (left class, rcset) membership;
- the K columns of an interpolated LM's state: one mixed-radix int64
  code per token (`InterNGramFsa.encode`);
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

import sys
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from aaltoasr_tpu_torch.decoder.lexicon import (
    PrefixTree, duration_table, node_duration_params)
from aaltoasr_tpu_torch.decoder.ngram import (
    NGramFsa, initial_code, lm_members, lm_num_codes)
from aaltoasr_tpu_torch.decoder.wordend import (
    NO_RECORD, WordEnds, records, stack_records, traceback)
from aaltoasr_tpu_torch.decoder.wordgraph import WordGraph
from aaltoasr_tpu_torch.device import resolve_device
from aaltoasr_tpu_torch.ops.logsemiring import LOG_ZERO
from aaltoasr_tpu_torch.utils.profiling import span

LN10 = 2.302585092994046
NEG_INF = float("-inf")
POS_INF = float("inf")
DEAD_KEY = torch.iinfo(torch.int64).max

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
                                    # table, 3 context (>= trigram,
                                    # keyed by the backoff-FSA state;
                                    # TokenPassSearch.cc:2084)
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
    reentry_topk: int = 0           # >0: each entry node takes its top-K
                                    # re-entering records (zero entry
                                    # log-probs, factored pair rows);
                                    # 0 = full [E, R] expansion
    word_end_beam: float = 0.0      # prune word ends vs the frame's best
                                    # word end (TokenPassSearch.cc:
                                    # 1076-1081); 0 = off
    reentry_prewalk: int = 0        # >0: each re-entering record keeps
                                    # its top-K entry nodes, ranked by
                                    # root arc + entry obs; 0 = all
    reentry_preselect: int = 0      # >0: each context row keeps its
                                    # static top-P entries (root arc +
                                    # unigram lookahead); 0 = full row
    reentry_records: int = 0        # >0: only the best K record slots
                                    # re-enter (all E are written)
    # pruning extensions (Toolbox.hh:182-221) against this frame's
    # bucket maxima: same tree depth, same committed-word count, fan-in
    # and fan-out networks, the same fan node; 0 = off
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


def context_lookahead_tables(tree, lm, la_ids, budget=32_000_000):
    """Per-LM-state lookahead lists for context (>= trigram) lookahead.

    The token's backoff-FSA state is its word history, so the
    reference's (w1, w2)-keyed trigram lookahead
    (`TokenPassSearch.cc:2084` get_lm_trigram_lookahead, `TreeGram.cc:549`
    fetch_trigram_list) becomes, per state s and node n:

        la(s, n) = max over backoff levels l of
                   bo(s..l) + max{ score of explicit successor w of
                                   state_l : w ends inside subtree(n) }
        floored by bo(s..unigram) + la1[n] (the unigram table).

    Subtree membership is an interval test on DFS positions; each state's
    explicit successors become padded (position, score) rows [S, amax].
    This upper-bounds the reference's per-word backoff max (a word with
    an explicit higher-order arc also appears at lower levels), which is
    admissible for pruning.  Returns None when the padded lists exceed
    the budget.
    """
    lo, hi = tree_dfs_intervals(tree)
    # word-end DFS positions per tree word
    we_w = np.asarray(tree.we_word)
    valid = np.asarray(tree.we_exit_logp) > LOG_ZERO / 2
    ends: dict = {}
    for n, h in zip(*np.nonzero(valid)):
        w = int(we_w[n, h])
        if w >= 0:
            ends.setdefault(w, []).append(int(lo[n]))
    # LM word id -> tree end positions (via the lookahead word ids)
    by_lm: dict = {}
    for w_t, wid in enumerate(la_ids):
        if wid >= 0:
            by_lm.setdefault(int(wid), []).extend(ends.get(w_t, []))
    S = lm.num_states
    sf = lm.state_first
    rows = [[]]                  # the unigram level rides the la1 table
    amax = 1
    for s in range(1, S):
        entries = []
        for i in range(int(sf[s]), int(sf[s + 1])):
            for p in by_lm.get(int(lm.trans_word[i]), ()):
                entries.append((p, float(lm.trans_prob[i])))
        rows.append(entries)
        amax = max(amax, len(entries))
    if S * amax > budget:
        return None
    la_pos = np.full((S, amax), -1, np.int32)
    la_sc = np.full((S, amax), LOG_ZERO, np.float32)
    for s, entries in enumerate(rows):
        for j, (p, sc) in enumerate(entries):
            la_pos[s, j] = p
            la_sc[s, j] = sc
    bo = np.asarray(lm.bo_weight, np.float32).copy()
    bo[0] = 0.0                  # stop accumulating at the unigram root
    return {"la_pos": la_pos, "la_sc": la_sc, "la_bo": bo,
            "la_bnext": np.asarray(lm.bo_next, np.int32),
            "la_lo": lo, "la_hi": hi}


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
    ``device``: the GPU unless the caller passes ``device="cpu"``.

    ``lm`` is an `NGramFsa` or an `InterNGramFsa` (its K member states
    ride as one mixed-radix code).  ``word_classes`` (`WordClasses`)
    makes each member's class the LM word and adds its membership
    log-prob to the pronunciation score; the tree is not modified."""

    def __init__(self, tree: PrefixTree, lm, model,
                 config: SearchConfig = SearchConfig(),
                 word_classes=None, lookahead_lm: NGramFsa | None = None,
                 device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        self.tree = tree
        self.lm = lm
        self.config = config
        N = tree.num_nodes
        members = lm_members(lm)
        self._K = len(members)
        self._num_codes = lm_num_codes(lm)
        # (node, LM state) fits one int64 sort key
        self._fused_key = N * self._num_codes < 2 ** 62
        # tree word id -> LM word id; words absent from the LM (or with
        # a missing multiword component) are pruned
        self.wordend = we = WordEnds(tree, lm, config, word_classes,
                                     self.device)
        lm_id, la_first, la_last = we.lm_id, we.first_names, we.last_names
        we_word = np.asarray(tree.we_word, np.int64)
        we_lmid = we.lm_ids(we_word)
        pdf = np.asarray(tree.pdf, np.int64)

        # static per-word unigram estimate (member 0) for the we_prewalk
        # ranking
        m0 = members[0]
        uni_row = np.full(m0.num_words + 1, -30.0, np.float32)
        lo0, hi0 = int(m0.state_first[0]), int(m0.state_first[1])
        uni_row[m0.trans_word[lo0:hi0]] = m0.trans_prob[lo0:hi0]
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
        self._la_ctx = False
        self._la_init_row = 0
        la_lm = lookahead_lm or m0
        we_law = la1 = ctx = None
        if self._la_on:
            V = la_lm.num_words
            if (config.lm_lookahead >= 3 and self._K == 1
                    and (lookahead_lm is None or lookahead_lm is lm)):
                # context (>= trigram) lookahead keyed by the token's FSA
                # state (get_lm_trigram_lookahead, TokenPassSearch.cc:
                # 2084)
                ctx = context_lookahead_tables(
                    tree, lm, [lm.word_index.get(w, -1) for w in la_first])
                if ctx is None:
                    print("BeamSearch: context lookahead unavailable for "
                          "this tree/LM; falling back", file=sys.stderr)
            if ctx is not None:
                self._la_ctx = True
                self._la_levels = max(lm.order - 1, 1)
                la1 = unigram_lookahead(tree, la_lm, la_first)
                iv_lo, iv_hi = ctx["la_lo"], ctx["la_hi"]
            elif (config.lm_lookahead >= 2
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
                    print("BeamSearch: bigram lookahead table over "
                          "budget; falling back to unigram",
                          file=sys.stderr)
                la1 = unigram_lookahead(tree, la_lm, la_first)

        def dev(a, dtype=None):
            return torch.as_tensor(np.asarray(a), dtype=dtype,
                                   device=self.device)

        i64 = torch.int64
        pt = np.asarray(tree.root_pair_tgt)
        plp = np.asarray(tree.root_pair_logp)
        rt = np.maximum(pt, 0)
        # per-node step tables: one int64 and one float32 row per token
        arc_c = np.maximum(arc_tgt, 0)
        ints = {"arc_tgt": arc_tgt, "arc_pdf": pdf[arc_c],
                "we_word": we_word, "we_skip": tree.we_skip_lm,
                "we_lmid": we_lmid, "we_pair": tree.we_pair}
        flts = {"arc_lp": arc_lp, "we_exit": tree.we_exit_logp,
                "we_pron": we.pron,
                "we_uni": np.where(we_word >= 0,
                                   uni_est[np.maximum(we_word, 0)], 0.0)}
        if config.overflow_tokens:
            ints["over_map"] = over_map
        if we_law is not None:
            ints["we_law"] = we_law
        if self._la_ctx:
            # DFS intervals and unigram base of the arc targets
            ints.update({"la_lo": iv_lo[arc_c], "la_hi": iv_hi[arc_c]})
            flts["la1"] = la1[arc_c]
        if self._has_durations:
            flts.update(node_duration_params(tree, model,
                                             config.duration_scale))
        self._rows_i = _RowTable(ints, np.int64, self.device)
        self._rows_f = _RowTable(flts, np.float32, self.device)

        t = {"pdf": dev(pdf, i64),
             "root_tgt": dev(pt, i64), "root_logp": dev(plp),
             "root_pdf": dev(pdf[rt], i64),
             "we_word": dev(we_word, i64), "we_lmid": dev(we_lmid, i64),
             "we_exit": dev(tree.we_exit_logp), "we_pron": dev(we.pron),
             "we_skip": dev(tree.we_skip_lm)}
        if config.overflow_tokens:
            t.update({"over_tgt": dev(o_tgt, i64), "over_lp": dev(o_lp),
                      "over_pdf": dev(pdf[o_tgt], i64)})
        if self._la_bigram:
            t["la2"] = dev(la2).reshape(-1)        # [(V+1) * N]
        elif self._la_ctx:
            for k in ("la_pos", "la_sc", "la_bo", "la_bnext"):
                t[k] = dev(ctx[k], i64 if k in ("la_pos", "la_bnext")
                           else None)
            t.update({"lart_lo": dev(iv_lo[rt], i64),
                      "lart_hi": dev(iv_hi[rt], i64),
                      "lart_1": dev(la1[rt])})
            if config.overflow_tokens:
                t.update({"laov_lo": dev(iv_lo[o_tgt], i64),
                          "laov_hi": dev(iv_hi[o_tgt], i64),
                          "laov_1": dev(la1[o_tgt])})
        elif self._la_on:
            t["la"] = dev(la1)

        # compact re-entry (reentry_topk): the entry-node union and the
        # factored pair membership (left class x rcset), as in the dense
        # engine
        self._reentry_topk = 0
        if config.reentry_topk:
            valid_rows = plp > LOG_ZERO / 2
            ent = np.unique(pt[valid_rows])
            NC, NR = tree.num_classes, tree.num_rcsets
            usable = (pt.shape[0] == NC * NR and len(ent) > 0
                      and not np.any(plp[valid_rows] != 0.0))
            if usable:
                M = len(ent)
                node_to_entry = np.full(N, M, np.int64)
                node_to_entry[ent] = np.arange(M)
                member = np.zeros((pt.shape[0], M), bool)
                rp, rr = np.nonzero(valid_rows)
                member[rp, node_to_entry[pt[rp, rr]]] = True
                m3 = member.reshape(NC, NR, M)
                left, first = m3.any(axis=1), m3.any(axis=0)
                usable = np.array_equal(
                    left[:, None, :] & first[None, :, :], m3)
            if usable:
                self._reentry_topk = int(config.reentry_topk)
                self._NR = NR
                t.update({"ent_node": dev(ent, i64),
                          "ent_pdf": dev(pdf[ent], i64),
                          "ent_left": dev(left), "ent_first": dev(first)})
                if self._la_ctx:
                    t.update({"laent_lo": dev(iv_lo[ent], i64),
                              "laent_hi": dev(iv_hi[ent], i64),
                              "laent_1": dev(la1[ent])})
            else:
                print("BeamSearch: reentry_topk unavailable for this tree "
                      "(non-factored or non-zero entry probs); using the "
                      "full [E, R] expansion", file=sys.stderr)

        # static re-entry preselect: each context pair's top-P entries by
        # the static part of the re-entry rank (root arc + lm_scale x
        # unigram lookahead), chosen on the host by a stable argsort
        self._reentry_pre = 0
        RPre = int(config.reentry_preselect or 0)
        if RPre and RPre <= pt.shape[1] and not self._reentry_topk:
            if config.reentry_prewalk:
                RPre = max(RPre, int(config.reentry_prewalk))
            static = plp.astype(np.float64).copy()
            la_np = (la1 if self._la_on and not (self._la_bigram
                                                 or self._la_ctx)
                     else unigram_lookahead(tree, m0, la_first))
            static = static + config.lm_scale_eff * la_np[rt]
            static[plp <= LOG_ZERO / 2] = -np.inf
            sel = np.argsort(-static, axis=1, kind="stable")[:, :RPre]
            pt_pre = np.take_along_axis(pt, sel, axis=1)
            rt_pre = np.maximum(pt_pre, 0)
            t.update({"root_tgt_pre": dev(pt_pre, i64),
                      "root_logp_pre": dev(np.take_along_axis(plp, sel,
                                                              axis=1)),
                      "root_pdf_pre": dev(pdf[rt_pre], i64)})
            if self._la_ctx:
                t.update({"lart_lo_pre": dev(iv_lo[rt_pre], i64),
                          "lart_hi_pre": dev(iv_hi[rt_pre], i64),
                          "lart_1_pre": dev(la1[rt_pre])})
            self._reentry_pre = RPre

        # pruning extensions: bucket tables, built only when a beam is on
        self._WCB = 200                      # MAX_WC_COUNT buckets
        self._carry_wc = bool(config.eq_word_count_beam)
        if config.eq_depth_beam:
            d2 = _entry_depth(tree) // 2
            self._DB = int(d2.max()) + 1
            t["depth2"] = dev(d2, i64)
        if ((config.fan_in_beam or config.fan_out_beam
             or config.tp_state_beam or config.eq_depth_beam
             or config.eq_word_count_beam) and tree.fan_flags is not None):
            t["fanflag"] = dev(tree.fan_flags, i64)
        self.t = t

    # -- pieces of the step -------------------------------------------------
    def _ctx_levels(self, states):
        """Context lookahead lists of [B, X] LM states: per backoff level
        the padded successor (DFS position, score) rows [B, X, amax] and
        the backoff sum before the level; and the sum past the last."""
        t = self.t
        levels = []
        acc = torch.zeros(states.shape, device=states.device)
        cur = states
        for _ in range(self._la_levels):
            levels.append((t["la_pos"][cur], t["la_sc"][cur], acc))
            acc = acc + t["la_bo"][cur]
            cur = t["la_bnext"][cur]
        return levels, acc

    @staticmethod
    def _ctx_la(levels, base_acc, lo, hi, la1):
        """Context lookahead of [B, X] tokens at their [B, X, A] targets
        (DFS interval [lo, hi), unigram base la1): the best successor
        score inside the target's subtree over the backoff levels, one
        level at a time (each level's [B, X, A, amax] mask is the peak
        intermediate)."""
        best = base_acc[..., None] + la1
        for pos, sc, acc in levels:
            p = pos[..., None, :]
            m = (p >= lo[..., None]) & (p < hi[..., None])
            v = torch.where(m, sc[..., None, :], NEG_INF).max(dim=-1).values
            best = torch.maximum(best, acc[..., None] + v)
        return best

    def _expand(self, src, a_tgt, a_lp, durb, allow_self):
        """Candidates along the arcs [B, K, A] of the selected tokens
        ``src`` (their fields, each [B, K]), flattened to [B, K*A]."""
        node, lm, am, lms, dur, rec, alive, law = src[:8]
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
        if self._carry_wc:
            c["wc"] = src[8][..., None].expand(shape)
        return {k: v.reshape(B, -1) for k, v in c.items()}

    def _step(self, tok, obs_t, step_idx: int):
        """One frame for [B, W] tokens (node, lm, am, lms, dur, rec,
        alive, law, and the committed-word count with
        ``eq_word_count_beam``); obs_t is the frame's [B, S] log-probs.
        Returns the new tokens and this frame's [B, E] records (word,
        previous record, am, lms)."""
        cfg = self.config
        t = self.t
        node, lmst, am, lms, dur, rec, alive, law = tok[:8]
        B, W = node.shape
        E = cfg.num_records
        H = self.tree.we_word.shape[1]
        ls = cfg.lm_scale_eff
        ts = cfg.transition_scale_eff
        ins = cfg.insertion_penalty_eff
        dvc = node.device
        with span("exact.expand"):
            ri = self._rows_i.rows(node)
            rf = self._rows_f.rows(node)
            if self._has_durations:
                d_ = torch.clamp(dur + 1, 1, cfg.max_dur).float()
                durb = rf["dur_valid"] * (rf["dur_lncoef"] * torch.log(d_)
                                          - d_ * rf["dur_invb"]
                                          + rf["dur_const"])
            else:
                durb = torch.zeros_like(am)
            if self._la_ctx:
                lev_tok, acc_tok = self._ctx_levels(lmst)

            # ---- 1. in-word expansion (+ branch arcs of the top-O tokens)
            groups = [self._expand(tok, ri["arc_tgt"], rf["arc_lp"], durb,
                                   True)]
            groups[0]["am"] = groups[0]["am"] + _take(
                obs_t, ri["arc_pdf"]).reshape(B, -1)
            if self._la_ctx:
                groups[0]["la"] = self._ctx_la(
                    lev_tok, acc_tok, ri["la_lo"], ri["la_hi"],
                    rf["la1"]).reshape(B, -1)
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
                if self._la_ctx:
                    lev_o = [tuple(_rows_at(x, sel_o) for x in lev)
                             for lev in lev_tok]
                    c1b["la"] = self._ctx_la(
                        lev_o, acc_tok.gather(1, sel_o), t["laov_lo"][o_row],
                        t["laov_hi"][o_row], t["laov_1"][o_row]).reshape(B, -1)
                groups.append(c1b)

        # ---- 2. word ends [W, H] -> (prewalk top-E2) -> LM walk ->
        #         records [E] -> context rows [Er, R]
        with span("exact.words"):
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
            per_tok = [rec, lmst] + ([tok[8]] if self._carry_wc else [])
            if E2 < WH:
                # rank word ends by a static unigram LM estimate; the exact
                # walk runs on the top E2
                pre = we_am + ls * (base_lms
                                    + torch.where(skip, 0.0, rf["we_uni"]))
                ord2 = top_k(torch.where(w_alive, pre, NEG_INF).reshape(B, WH),
                             E2)

                def pick(x):
                    return x.reshape(B, WH).gather(1, ord2)

                s_tok = [x.gather(1, ord2 // H) for x in per_tok]
            else:
                E2 = WH

                def pick(x):
                    return x.reshape(B, WH)

                s_tok = [pick(x[..., None].expand(B, W, H)) for x in per_tok]
            s_prev, s_state = s_tok[:2]
            s_word, s_am, s_base, s_skip = (pick(w_word), pick(we_am),
                                            pick(base_lms), pick(skip))
            s_alive, s_pair, s_law = (pick(w_alive), pick(ri["we_pair"]),
                                      pick(w_law))
            lm_next, lm_score = self.wordend.walk_words(s_state, s_word,
                                                        pick(w_lmid))
            lm_next, lm_score, lm_ok = self.wordend.commit(
                s_state, s_word, lm_next, lm_score, s_skip)
            we_lms2 = s_base + lm_score
            we_alive2 = s_alive & lm_ok
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
            recs, new_rec = records(e_alive, e_word, e_prev, step_idx,
                                    (e_am, e_lms))

            # re-entry: the best Er records (records are best-first) through
            # their context rows
            Er = min(cfg.reentry_records, E) if cfg.reentry_records else E
            re_f = [e_alive, e_lm, e_am, e_lms, e_pair, e_law, new_rec]
            if self._carry_wc:
                # committed-word count (silences and OOL words do not count)
                re_f.append(s_tok[2].gather(1, order) + (e_word >= 0).long())
            re_f = [x[:, :Er] for x in re_f]
            e_alive, e_lm, e_am, e_lms, e_pair, e_law, re_rec = re_f[:7]
            if self._la_ctx:
                # re-entry candidates rank in the post-commit context
                lev_e, acc_e = self._ctx_levels(e_lm)
            if self._reentry_topk:
                groups.extend(self._reentry_compact(
                    obs_t, re_f, lev_e if self._la_ctx else None,
                    acc_e if self._la_ctx else None))
            else:
                groups.append(self._reentry_rows(
                    obs_t, re_f, lev_e if self._la_ctx else None,
                    acc_e if self._la_ctx else None))
            cand = {k2: torch.cat([g[k2] for g in groups], dim=1)
                    for k2 in groups[0]}

        # ---- 3. global beam, pruning extensions, recombination, top-W
        with span("exact.prune"):
            total = cand["am"] + ls * cand["lms"]
            if self._la_ctx:
                total = total + ls * cand["la"]
            elif self._la_bigram:
                total = total + ls * t["la2"][cand["law"] * self.tree.num_nodes
                                              + cand["node"]]
            elif self._la_on:
                total = total + ls * t["la"][cand["node"]]
            c_alive = cand["alive"]
            total = torch.where(c_alive, total, NEG_INF)
            best = total.max(dim=1, keepdim=True).values
            c_alive = c_alive & (total >= best - cfg.beam)
            c_alive = self._prune_extensions(cand, total, c_alive)
            sel, new_alive = recombine(cand["node"], cand["lm"], total,
                                       c_alive, self._num_codes, W,
                                       self._fused_key)
            new_tok = tuple(cand[k2].gather(1, sel) for k2 in
                            ("node", "lm", "am", "lms", "dur", "rec"))
            new_tok = new_tok + (new_alive, cand["law"].gather(1, sel))
            if self._carry_wc:
                new_tok = new_tok + (cand["wc"].gather(1, sel),)
        return new_tok, recs

    def _reentry_rows(self, obs_t, re_f, lev_e, acc_e):
        """Re-entry candidates of the [B, Er] records through their
        context rows [R] (or the preselected top-P of each row), with
        ``reentry_prewalk`` each record's RK best entries by root arc +
        entry obs."""
        cfg = self.config
        t = self.t
        e_alive, e_lm, e_am, e_lms, e_pair, e_law, re_rec = re_f[:7]
        pre = "_pre" if self._reentry_pre else ""
        r_tgt = t["root_tgt" + pre][e_pair]              # [B, Er, R]
        r_lp = t["root_logp" + pre][e_pair]
        obs2 = _take(obs_t, t["root_pdf" + pre][e_pair])
        la_c2 = None
        if lev_e is not None:
            la_c2 = self._ctx_la(lev_e, acc_e, t["lart_lo" + pre][e_pair],
                                 t["lart_hi" + pre][e_pair],
                                 t["lart_1" + pre][e_pair])
        R = r_tgt.shape[2]
        RK = min(cfg.reentry_prewalk, R) if cfg.reentry_prewalk else 0
        if RK and RK < R:
            # each record keeps its RK best entry nodes by root arc +
            # entry obs (the record's own score is constant in its row)
            rank2 = r_lp + obs2
            if self._la_on and not (self._la_bigram or self._la_ctx):
                rank2 = rank2 + cfg.lm_scale_eff * t["la"][r_tgt]
            rank2 = torch.where(r_lp > LOG_ZERO / 2, rank2, NEG_INF)
            idxr = top_k(rank2, RK)                      # [B, Er, RK]
            r_tgt, r_lp, obs2 = (x.gather(2, idxr) for x in (r_tgt, r_lp,
                                                             obs2))
            if la_c2 is not None:
                la_c2 = la_c2.gather(2, idxr)
        shape = r_tgt.shape
        c2 = {"node": r_tgt,
              "lm": e_lm[..., None].expand(shape),
              "am": e_am[..., None] + r_lp + obs2,
              "lms": e_lms[..., None].expand(shape),
              "dur": torch.zeros(shape, dtype=torch.int64,
                                 device=r_tgt.device),
              "rec": re_rec[..., None].expand(shape),
              "alive": e_alive[..., None] & (r_lp > LOG_ZERO / 2),
              "law": e_law[..., None].expand(shape)}
        if self._carry_wc:
            c2["wc"] = re_f[7][..., None].expand(shape)
        if la_c2 is not None:
            c2["la"] = la_c2
        return {k: v.reshape(shape[0], -1) for k, v in c2.items()}

    def _reentry_compact(self, obs_t, re_f, lev_e, acc_e):
        """``reentry_topk``: entry log-probs are zero, so a re-entry
        candidate scores record total + obs[entry node], and per entry
        node the records rank by their totals masked by pair membership.
        Each of K2 rounds gives every entry node its best record not yet
        taken: K2 groups of [B, M] candidates."""
        cfg = self.config
        t = self.t
        e_alive, e_lm, e_am, e_lms, e_pair, e_law, re_rec = re_f[:7]
        B, Er = e_alive.shape
        NR = self._NR
        e_total = torch.where(e_alive, e_am + cfg.lm_scale_eff * e_lms,
                              NEG_INF)
        avail = t["ent_left"][e_pair // NR] & t["ent_first"][e_pair % NR]
        M = avail.shape[2]
        obs_m = obs_t[:, t["ent_pdf"]]                   # [B, M]
        ent = t["ent_node"].expand(B, M)
        rows = torch.arange(Er, device=e_alive.device)[None, :, None]
        out = []
        for _ in range(self._reentry_topk):
            enter = torch.where(avail, e_total[..., None], NEG_INF)
            best, win = enter.max(dim=1)                 # [B, M]
            avail = avail & (rows != win[:, None, :])
            c = {"node": ent, "lm": e_lm.gather(1, win),
                 "am": e_am.gather(1, win) + obs_m,
                 "lms": e_lms.gather(1, win),
                 "dur": torch.zeros_like(win),
                 "rec": re_rec.gather(1, win),
                 "alive": best > LOG_ZERO / 2,
                 "law": e_law.gather(1, win)}
            if self._carry_wc:
                c["wc"] = re_f[7].gather(1, win)
            if lev_e is not None:
                lev_w = [tuple(_rows_at(x, win) for x in lev)
                         for lev in lev_e]
                c["la"] = self._ctx_la(
                    lev_w, acc_e.gather(1, win),
                    t["laent_lo"][None, :, None],
                    t["laent_hi"][None, :, None],
                    t["laent_1"][None, :, None])[..., 0]
            out.append(c)
        return out

    def _prune_extensions(self, cand, total, c_alive):
        """The pruning extensions (TokenPassSearch.cc:1083-1127) against
        bucket maxima of this frame's candidates after the global beam
        (the reference uses the previous frame's, cc:320-360; the
        same-frame maxima are tighter)."""
        cfg = self.config
        t = self.t
        if not (cfg.eq_depth_beam or cfg.eq_word_count_beam
                or cfg.fan_in_beam or cfg.fan_out_beam
                or cfg.tp_state_beam):
            return c_alive
        node = cand["node"]
        B = node.shape[0]
        atot = torch.where(c_alive, total, NEG_INF)
        ff = (t["fanflag"][node] if "fanflag" in t
              else torch.zeros_like(node))
        is_fan = ff > 0

        def bucket_max(bucket, size):
            return torch.full((B, size), NEG_INF, device=node.device
                              ).scatter_reduce(1, bucket, atot, "amax",
                                               include_self=True
                                               ).gather(1, bucket)

        if cfg.eq_depth_beam:
            db = t["depth2"][node]
            c_alive = c_alive & ((total >= bucket_max(db, self._DB)
                                  - cfg.eq_depth_beam) | is_fan)
        if cfg.eq_word_count_beam:
            wcb = cand["wc"].clamp(0, self._WCB - 1)
            c_alive = c_alive & ((total >= bucket_max(wcb, self._WCB)
                                  - cfg.eq_word_count_beam) | is_fan)
        for beam, bit in ((cfg.fan_in_beam, 1), (cfg.fan_out_beam, 2)):
            if beam and "fanflag" in t:
                f = (ff & bit) > 0
                fmax = torch.where(f, atot, NEG_INF).max(
                    dim=1, keepdim=True).values
                c_alive = c_alive & (~f | (total >= fmax - beam))
        if cfg.tp_state_beam and "fanflag" in t:
            # at fan nodes: against the best candidate at the same node
            nmax = bucket_max(node, self.tree.num_nodes)
            c_alive = c_alive & (~is_fan
                                 | (total >= nmax - cfg.tp_state_beam))
        return c_alive

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

        tok = (node0.contiguous(), full(lm_init, torch.int64), am0,
               full(0.0, torch.float32), full(0, torch.int64),
               full(-1, torch.int64), alive0.contiguous(),
               full(self._la_init_row, torch.int64))
        return tok + ((full(0, torch.int64),) if self._carry_wc else ())

    def _final_commit(self, node, lmst, lms):
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
        sc, end2, lm_ok = self.wordend.final_walk(
            lmst[..., None].expand(wW.shape), wW, lmid)
        alt = (lms[..., None] + t["we_pron"][node] + cfg.insertion_penalty_eff
               + (sc + end2))
        alt = torch.where(ok & lm_ok, alt, NEG_INF)
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
        node, lmst, am, lms, dur, rec, alive, law = tok[:8]
        if cfg.require_sentence_end and self.wordend.end_id is not None:
            end_sc = self.wordend.end_score(lmst)
            base_lms = lms + torch.where(alive, end_sc, 0.0)
            # committed-at-final alternative: a token that reached a
            # word's last state by the final frame is committed there in
            # the reference (`WordEnds.base_ok` says whether the uncommitted
            # interpretation exists too); the commit pays pron + LM +
            # </s> but no exit transition or duration
            aw, alms = self._final_commit(node, lmst, lms)
            alt_total = torch.where(alive & (aw >= 0), am + ls * alms,
                                    NEG_INF)
            base_total = torch.where(alive & self.wordend.base_ok[node],
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
        recs = [[] for _ in range(4 if lattice else 2)]
        for i in range(T - 1):
            new_tok, rows = self._step(tok, obs[:, i + 1], i)
            if (i + 1 < n_frames).all():   # host counts: no device sync
                tok = new_tok
            else:
                v = (i + 1 < n_dev)[:, None]
                tok = tuple(torch.where(v, a, b) for a, b in zip(new_tok, tok))
                rows = tuple(torch.where(v, r, f)
                             for r, f in zip(rows, NO_RECORD))
            for lst, r in zip(recs, rows):
                lst.append(r)
        return self._finalize(tok), stack_records(
            recs, B, self.config.num_records, obs.device)

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
        finals, recs = self._decode(obs, n, initial_code(self.lm, sentence_start),
                                    lattice)
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


def _rows_at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b, j], ...] for a batched x [B, M, ...] and idx [B, J]."""
    b = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[b, idx]


def _entry_depth(tree) -> np.ndarray:
    """[N] node depth: the BFS distance in HMM states from the word-entry
    nodes over in-word arcs (unreached nodes 0), for the eq-depth buckets
    (the reference's m_depth_llh, TokenPassSearch.cc:1092)."""
    at = np.asarray(tree.arc_tgt)
    alp = np.asarray(tree.arc_logp)
    depth = np.full(tree.num_nodes, -1, np.int64)
    q = deque()
    for n0 in np.unique(np.asarray(tree.root_pair_tgt)[
            np.asarray(tree.root_pair_logp) > LOG_ZERO / 2]):
        depth[n0] = 0
        q.append(int(n0))
    while q:
        u = q.popleft()
        for a in range(at.shape[1]):
            v = int(at[u, a])
            if alp[u, a] > LOG_ZERO / 2 and v != u and depth[v] < 0:
                depth[v] = depth[u] + 1
                q.append(v)
    depth[depth < 0] = 0
    return depth


def recombine(node, lm, total, alive, num_states: int, W: int,
              fused_key: bool = True):
    """Recombination and the top-W cut of [B, C] candidates: the first
    live candidate per (node, LM state) in (node, state, -total, index)
    order survives, and the W best survivors by total (ties in (node,
    state) order) become the tokens.  Returns (sel [B, W] candidate
    rows, alive [B, W]).

    The reference sorts (node, state, -total) lexicographically in one
    stable sort; here a stable sort by -total, then a stable sort by the
    int64 key node * num_states + state, give the same order (without
    ``fused_key``, where node * num_states would not fit int64, a stable
    sort by the state and then one by the node).  -0.0 and 0.0 compare
    equal in both, as the reference canonicalizes zeros.
    """
    B = node.shape[0]
    neg_total = torch.where(alive, -total, POS_INF)
    p1 = torch.sort(neg_total, dim=1, stable=True).indices
    if fused_key:
        key = torch.where(alive, node * num_states + lm, DEAD_KEY)
        s_key, p2 = torch.sort(key.gather(1, p1), dim=1, stable=True)
        s_idx = p1.gather(1, p2)
        diff = s_key[:, 1:] != s_key[:, :-1]
    else:
        s_idx = p1
        for key in (lm, torch.where(alive, node, DEAD_KEY)):
            s_idx = s_idx.gather(1, torch.sort(key.gather(1, s_idx), dim=1,
                                               stable=True).indices)
        s_lm, s_key = lm.gather(1, s_idx), torch.where(
            alive, node, DEAD_KEY).gather(1, s_idx)
        diff = (s_key[:, 1:] != s_key[:, :-1]) | (s_lm[:, 1:] != s_lm[:, :-1])
    first = torch.cat([torch.ones((B, 1), dtype=torch.bool,
                                  device=node.device), diff], dim=1)
    s_alive = first & (s_key != DEAD_KEY)
    neg2 = torch.where(s_alive, neg_total.gather(1, s_idx), POS_INF)
    v2, p3 = torch.sort(neg2, dim=1, stable=True)
    return s_idx.gather(1, p3[:, :W]), v2[:, :W] < POS_INF


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


class StreamingDecoder:
    """Frame-by-frame push decoding of one utterance: the reference's
    OneFrameAcoustics path (`decoder/src/OneFrameAcoustics.{hh,cc}`,
    Toolbox::set_one_frame + run, Toolbox.hh:123-145) over a
    `BeamSearch`, on its device.

    Each pushed frame runs the search's batched step at B=1, and its
    record row goes into a device buffer of ``buffer_frames`` rows that
    doubles when full: nothing in `push_frame` or `push_frames` waits for
    the device, and a block is the same as as many single pushes.
    `partial()` follows the best token's record chain on the device (at
    most ``partial_words`` dependent gathers) and fetches the ids once;
    `result()` fetches the finals and the records once and traces back
    on the host.  `partial()` keeps the reference's horizon: the chain
    stops at pointers below ``(rows - ring_frames + buffer_frames) * E``
    (rows = frames - 1), those its ring of ``ring_frames`` record rows
    would have overwritten; `result()` is never cut.
    """

    def __init__(self, search: BeamSearch, sentence_start: str = "<s>",
                 buffer_frames: int = 256, ring_frames: int = 16384,
                 partial_words: int = 64):
        self.search = search
        self._sentence_start = sentence_start
        self._buffer_frames = buffer_frames
        self._ring_frames = ring_frames
        self._partial_cap = partial_words
        self.reset()

    def reset(self) -> None:
        """Start a new utterance."""
        self._frame = 0
        self._tokens = None
        # [rows, E, 4] float64: word, previous record, am, lms (the ints
        # and the float32 scores are exact in float64)
        self._recs = None
        self._lm_init = initial_code(self.search.lm, self._sentence_start)

    @property
    def frame(self) -> int:
        """Frames pushed so far."""
        return self._frame

    def push_frame(self, log_probs) -> None:
        """Feed one frame of state log-probs (set_one_frame + run)."""
        self.push_frames(torch.as_tensor(log_probs).reshape(1, -1))

    def push_frames(self, log_probs) -> None:
        """Feed a [K, S] block of state log-probs: K single pushes (span
        ``stream.push``; the step's phases are ``exact.expand``,
        ``exact.words`` and ``exact.prune``)."""
        s = self.search
        with span("stream.push", self._frame):
            obs = torch.as_tensor(log_probs, dtype=torch.float32,
                                  device=s.device)
            if obs.ndim == 1:
                obs = obs[None]
            for k in range(obs.shape[0]):
                if self._tokens is None:
                    self._tokens = s._seed_tokens(obs[k:k + 1],
                                                  self._lm_init)
                else:
                    i = self._frame - 1
                    self._tokens, rows = s._step(self._tokens,
                                                 obs[k:k + 1], i)
                    self._store(i, rows)
                self._frame += 1

    def _store(self, i: int, rows) -> None:
        """Write step i's [1, E] record row, doubling a full buffer."""
        if self._recs is None or i == self._recs.shape[0]:
            E = self.search.config.num_records
            cap = (self._buffer_frames if self._recs is None
                   else 2 * self._recs.shape[0])
            new = torch.empty((max(cap, 1), E, 4), dtype=torch.float64,
                              device=self.search.device)
            if self._recs is not None:
                new[:i] = self._recs
            self._recs = new
        for j, r in enumerate(rows):
            self._recs[i, :, j] = r[0]

    def partial(self) -> list:
        """The best token's newest <= ``partial_words`` words (no
        sentence-end finalization), traced back on the device; one
        fetch (span ``stream.partial``)."""
        with span("stream.partial", self._frame):
            if self._tokens is None:
                raise RuntimeError("no frames pushed")
            s = self.search
            cfg = s.config
            am, lms, _dur, rec, alive = self._tokens[2:7]
            rows = self._frame - 1
            if rows == 0:
                return []
            total = torch.where(alive, am + cfg.lm_scale_eff * lms, NEG_INF)
            ptr = rec.gather(1, total.argmax(dim=1, keepdim=True))[0, 0]
            E = cfg.num_records
            lo = max((rows - self._ring_frames + self._buffer_frames) * E, 0)
            flat = self._recs.view(-1, 4)
            words = []
            for _ in range(self._partial_cap):
                ok = ptr >= lo
                row = torch.where(ok, flat[ptr.clamp(min=0)], -1.0)
                words.append(row[0])
                ptr = row[1].long()
            ids = torch.stack(words).cpu().numpy()[::-1]
            return expand_word_boundaries(
                [s.tree.vocab[int(i)] for i in ids if i >= 0], cfg)

    def result(self) -> "DecodeResult":
        """The best hypothesis so far, finalized as at the utterance's
        end (callable any time); one fetch."""
        if self._tokens is None:
            raise RuntimeError("no frames pushed")
        s = self.search
        E = s.config.num_records
        rows = self._frame - 1
        parts = [torch.stack([f[0].double() for f in
                              s._finalize(self._tokens)])]
        if rows:
            parts.append(self._recs[:rows].reshape(-1))
        host = torch.cat(parts).cpu().numpy()
        recs = host[5:].reshape(rows, E, 4)
        return DecodeResult(
            search=s, final_ptr=int(host[0]), log_prob=float(host[1]),
            final_am=float(host[2]), final_lms=float(host[3]),
            rec_words=recs[..., 0].astype(np.int64),
            rec_prevs=recs[..., 1].astype(np.int64),
            rec_ams=recs[..., 2].astype(np.float32),
            rec_lmss=recs[..., 3].astype(np.float32),
            final_word=int(host[4]))
