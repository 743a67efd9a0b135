"""The word-end commit rule of both engines and the records it leaves.

A hypothesis leaving a word's last state commits the word (each engine
picks and masks its word ends its own way): the word walks the LM as
its LM id, or with ``split_multiwords`` as its components
(TokenPassSearch.cc:1818-1843); a skip word (a silence, or
``we_skip_lm``) keeps its LM state and scores 0; in morph mode
(``word_boundary``) a boundary right after a boundary is pruned and a
mid-utterance sentence end restarts the LM through <s> + the boundary
(TokenPassSearch.cc:869-873, 888-919); at the final frame the sentence
end is walked from the new state.  `records` writes a frame's word ends
in the format `traceback` and `WordGraph.from_records` read.
"""

from __future__ import annotations

import numpy as np
import torch

from aaltoasr_tpu_torch.decoder.lexicon import PrefixTree
from aaltoasr_tpu_torch.decoder.ngram import (
    lm_members, lm_tables, member0_states, reset_code, walk_codes)
from aaltoasr_tpu_torch.ops.logsemiring import LOG_ZERO


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


class WordEnds:
    """The commit rule of one (tree, LM, config) triple on ``device``;
    for the engines' set-up also the host tables ``lm_id``,
    ``first_names`` and ``last_names`` (`multiword_components`) and
    ``pron`` [N, H] (with ``word_classes``, membership log-probs added)."""

    def __init__(self, tree: PrefixTree, lm, config, word_classes=None,
                 device: torch.device | str = "cpu"):
        self.lm = lm
        lm_names = (word_classes.lm_word_names(tree.vocab)
                    if word_classes is not None else tree.vocab)
        self.pron = (word_classes.pron_logp(tree) if word_classes is not None
                     else tree.we_pron_logp)
        comp, self.lm_id, self.first_names, self.last_names = (
            multiword_components(lm_names, lm, config.split_multiwords))
        self.mw_comp = torch.as_tensor(comp, dtype=torch.int64,
                                       device=device)
        self.tables = lm_tables(lm, device)
        self.end_id = lm.word_index.get(config.sentence_end)
        # a hypothesis resting on a node whose only role is ending words
        # (non-skip word ends, no continuation arc, no skip/silence end)
        # has no uncommitted interpretation in the reference (word ids
        # live on dedicated word-end nodes there)
        valid_we = tree.we_exit_logp > LOG_ZERO / 2
        has_arc = ((tree.arc_tgt != np.arange(tree.num_nodes)[:, None])
                   & (tree.arc_logp > LOG_ZERO / 2)).any(axis=1)
        nonskip_we = (valid_we & (tree.we_word >= 0)
                      & ~tree.we_skip_lm).any(axis=1)
        skip_we = (valid_we & ((tree.we_word < 0)
                               | tree.we_skip_lm)).any(axis=1)
        self.base_ok = torch.as_tensor(has_arc | ~nonskip_we | skip_we,
                                       device=device)
        # morph mode: the boundary word's tree id, member 0's states
        # whose context ends with it, and the sentence end's reset code
        # (<s> then the boundary in every member, scores discarded)
        self.wb_tid = (tree.word_index.get(config.word_boundary, -1)
                       if config.word_boundary else -1)
        self.end_tid = tree.word_index.get(config.sentence_end, -1)
        if self.wb_tid >= 0:
            m0 = lm_members(lm)[0]
            wbl = m0.word_index.get(config.word_boundary, -1)
            self.is_wb_state = torch.as_tensor(
                m0.states_ending_with(wbl) if wbl >= 0
                else np.zeros(m0.num_states, bool), device=device)
            self.wb_reset = reset_code(lm, config.word_boundary)

    def lm_ids(self, words: np.ndarray) -> np.ndarray:
        """The LM ids of tree ``words`` (-1 for a silence, word < 0)."""
        return np.where(words >= 0, self.lm_id[np.maximum(words, 0)], -1)

    def walk(self, states, words):
        """(LM codes, LM word ids) -> (next codes, log-probs)."""
        return walk_codes(self.lm, self.tables, states, words)

    def walk_words(self, states, words, lmids):
        """The LM walk of tree ``words`` (their LM ids ``lmids``) from
        ``states``, with multiword components one component at a time.
        -> (next codes, log-probs)."""
        if self.mw_comp.shape[1] == 1:
            return self.walk(states, lmids.clamp(min=0))
        return walk_components(self.walk, states,
                               self.mw_comp[words.clamp(min=0)])

    def commit(self, states, words, nxt, score, skip=None):
        """The walk ``(nxt, score)`` of ``words`` from ``states`` as a
        commit: where ``skip`` the word keeps its state and scores 0; in
        morph mode a boundary after a boundary is not ``ok`` and a
        sentence end resets the LM.  -> (next, score, ok)"""
        if skip is not None:
            nxt = torch.where(skip, states, nxt)
            score = torch.where(skip, 0.0, score)
        ok = score > LOG_ZERO / 2
        if self.wb_tid >= 0:
            prev_wb = self.is_wb_state[member0_states(self.lm, states)]
            ok = ok & ~((words == self.wb_tid) & prev_wb)
            if self.end_tid >= 0:
                nxt = torch.where(words == self.end_tid, self.wb_reset, nxt)
        return nxt, score, ok

    def end_score(self, states):
        """The sentence end's log-prob from ``states`` (zeros when the LM
        has no sentence end)."""
        if self.end_id is None:
            return torch.zeros(states.shape, device=states.device)
        return self.walk(states, torch.full_like(states, self.end_id))[1]

    def final_walk(self, states, words, lmids):
        """Non-skip ``words`` committed from ``states`` at the final
        frame.  -> (the word's log-prob, the sentence end's from the new
        state, ok)"""
        nxt, score = self.walk_words(states, words, lmids)
        nxt, score, ok = self.commit(states, words, nxt, score)
        return score, self.end_score(nxt), ok


def records(alive, words, prev, step: int, scores=()):
    """A frame's records of [B, E] word ends and the pointers they hand
    on.  A live end records its word (dead: -1); a word (>= 0) also
    records its previous record pointer and ``scores`` (else -1 and 0)
    and hands on its own pointer, step * E + slot; a silence (word < 0)
    hands on its previous pointer.  -> ((word, previous, *scores),
    pointers)"""
    E = words.shape[1]
    is_word = alive & (words >= 0)
    recs = (torch.where(alive, words, -1), torch.where(is_word, prev, -1))
    recs += tuple(torch.where(is_word, s, 0.0) for s in scores)
    slot_ptr = step * E + torch.arange(E, device=words.device)
    return recs, torch.where(is_word, slot_ptr, prev)


# an invalid frame's record: no word, no previous record, scores 0
NO_RECORD = (-1, -1, 0.0, 0.0)


def stack_records(rows, B: int, E: int, device):
    """Per-field lists of [B, E] frame records -> [B, F, E] arrays."""
    return [torch.stack(lst, 1) if lst else
            torch.full((B, 0, E), f, device=device,
                       dtype=torch.int64 if j < 2 else torch.float32)
            for j, (lst, f) in enumerate(zip(rows, NO_RECORD))]


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
