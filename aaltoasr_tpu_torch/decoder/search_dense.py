"""Dense-node beam search: one hypothesis per tree node, batched.

Counterpart of `aaltoasr_tpu/decoder/search_dense.py` with the same
tables and the same step, written with plain index ops and an explicit
batch axis: every state array is ``[B, N]`` over the tree's N nodes.
The reference keeps one hypothesis per node (the Viterbi approximation
at node level); re-entry after word ends carries the top-C distinct
word-end histories per frame.

Step per frame:
1. in-arc relaxation: score[n] = max over in-arcs of score[src] + trans
   + duration.  Almost every arc moves the node index by 0, 1 or 2
   (self / next / skip), so those relax as shifts; the irregular rest
   relaxes through a padded [Mi, F] by-target table.
2. word ends (from the previous frame's state): a cheap static LM
   estimate ranks all slots, the exact FSA walk runs on the top E, and
   E traceback records are written.
3. re-entry: the top C word ends enter through their context-pair rows
   (cross-word fan-in), competing with in-tree arrivals.
4. observation log-likelihoods, then the global beam.
Phases 2 and 3's [B, C] part read only the previous state and run
first; the per-node work of 1, 3 and 4 is then one node pass and one
beam pass: on a card the two CUDA kernels of `ops/dense_cuda.py`, which
read and write the [B, N] state once, else the same ops in plain
PyTorch (`_node_pass_plain`, `_beam_pass_plain`), bit for bit alike.

Top-E and top-C selections break ties by lower index, as
`jax.lax.top_k` does.  Sums x + lm_scale * y are one fused multiply-add
(`fma`), as XLA computes them on the CPU: rounded twice, they move
totals by an ulp, and near-tied hypotheses then resolve otherwise than
the reference's.  Frames run as a Python loop; the records stay
on the device until it ends, then one fetch brings them to the host for
the 1-best traceback.  With ``lattice`` (the default) the records also
carry each word's cumulative am and lm scores, for
`DecodeResult.word_graph`; ``records_half`` sends those scores as
bfloat16.  An interpolated LM (`InterNGramFsa`) rides as one mixed-radix
state code per node, as in the exact engine, and word classes
(`WordClasses`) adjust the LM words and pronunciation scores of a copy
of the tree's tables.
"""

from __future__ import annotations

import numpy as np
import torch

from aaltoasr_tpu_torch.decoder.lexicon import (
    PrefixTree, duration_table, node_duration_params)
from aaltoasr_tpu_torch.decoder.ngram import initial_code, lm_members
from aaltoasr_tpu_torch.decoder.search import (
    DecodeResult, SearchConfig, expand_word_boundaries, top_k)
from aaltoasr_tpu_torch.decoder.wordend import (
    NO_RECORD, WordEnds, records, stack_records, traceback)
from aaltoasr_tpu_torch.device import resolve_device
from aaltoasr_tpu_torch.ops import dense_cuda
from aaltoasr_tpu_torch.ops.logsemiring import LOG_ZERO
from aaltoasr_tpu_torch.utils.profiling import count, span

NEG_INF = float("-inf")
# C: word-end histories re-entered per frame (the reference's default
# reentry_width; no caller sets another)
REENTRY_WIDTH = 4


def _shift_structure(tree: PrefixTree):
    """Split in-arcs into index-shift classes (target - source in
    {0, 1, 2}) and irregular leftovers grouped by target into a padded
    [Mi, F] source table; the first arc per (shift, target) takes the
    shift, duplicates stay irregular."""
    N, A = tree.arc_tgt.shape
    shifts = {d: np.full(N, LOG_ZERO, np.float32) for d in (0, 1, 2)}
    src = np.repeat(np.arange(N, dtype=np.int64), A)
    tgt = tree.arc_tgt.reshape(-1).astype(np.int64)
    lp = tree.arc_logp.reshape(-1).astype(np.float32)
    valid = lp > LOG_ZERO / 2
    delta = tgt - src
    irregular = valid.copy()
    for d in (0, 1, 2):
        idx = np.nonzero(valid & (delta == d))[0]
        _, first = np.unique(tgt[idx], return_index=True)
        take = idx[first]
        shifts[d][tgt[take]] = lp[take]
        irregular[take] = False
    by_tgt: dict = {}
    for i in np.nonzero(irregular)[0]:
        by_tgt.setdefault(int(tgt[i]), []).append((int(src[i]), float(lp[i])))
    targets = sorted(by_tgt)
    Mi = max(len(targets), 1)
    F = max((len(v) for v in by_tgt.values()), default=1)
    grp_src = np.zeros((Mi, F), np.int64)
    grp_lp = np.full((Mi, F), LOG_ZERO, np.float32)
    # inverse map: node -> compact row (Mi = "no irregular in-arcs")
    inv = np.full(N, Mi, np.int64)
    for m, t in enumerate(targets):
        inv[t] = m
        for f, (n, l) in enumerate(by_tgt[t]):
            grp_src[m, f] = n
            grp_lp[m, f] = l
    return shifts, grp_src, grp_lp, inv


def fma(x: torch.Tensor, y: torch.Tensor, s: float) -> torch.Tensor:
    """x + s * y rounded once, as XLA fuses it on the CPU (torch's add
    with alpha is a fused multiply-add on the CPU and the GPU)."""
    return torch.add(x, y, alpha=s)


def _shift(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    """x[:, n - k] along the node axis, `fill` for n < k."""
    pad = torch.full((x.shape[0], k), fill, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[:, :-k]], dim=1)


class DenseBeamSearch:
    """Dense-mode batched decoder for one (tree, LM, model) triple, on
    ``device``: the GPU unless the caller passes ``device="cpu"``."""

    _traceback_cap = 100000     # word-chain safety bound (per utterance
                                # min(cap, T): at most one word a frame)

    def __init__(self, tree: PrefixTree, lm, model,
                 config: SearchConfig = SearchConfig(), word_classes=None,
                 device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        if config.num_records < REENTRY_WIDTH:
            raise ValueError(f"num_records must be >= {REENTRY_WIDTH}")
        self.tree = tree
        self.lm = lm
        self.config = config
        shifts, grp_src, grp_lp, grp_inv = _shift_structure(tree)

        # compact re-entry space: the union of all context-pair row
        # targets (the only nodes stage 3 can write)
        pt = np.asarray(tree.root_pair_tgt)
        plp = np.asarray(tree.root_pair_logp)
        entry_nodes = np.unique(pt[plp > LOG_ZERO / 2])
        if len(entry_nodes) == 0:
            entry_nodes = np.zeros(1, dtype=pt.dtype)
        M_entry = len(entry_nodes)
        node_to_entry = np.full(tree.num_nodes, M_entry, np.int64)
        node_to_entry[entry_nodes] = np.arange(M_entry)
        # pair membership factors as (left-class mask) x (rcset mask):
        # pair = cls * NR + rc (the cross-word builder's invariant)
        NC, NR = tree.num_classes, tree.num_rcsets
        if pt.shape[0] != NC * NR:
            raise ValueError("pair rows are not num_classes x num_rcsets")
        valid_rows = plp > LOG_ZERO / 2
        if np.any(plp[valid_rows] != 0.0):
            raise ValueError("dense re-entry assumes zero entry log-probs")
        member = np.zeros((pt.shape[0], M_entry), bool)
        rows_p, rows_r = np.nonzero(valid_rows)
        member[rows_p, node_to_entry[pt[rows_p, rows_r]]] = True
        m3 = member.reshape(NC, NR, M_entry)
        left_mem = m3.any(axis=1)              # [NC, M]
        first_mem = m3.any(axis=0)             # [NR, M]
        if not np.array_equal(left_mem[:, None, :] & first_mem[None, :, :],
                              m3):
            raise ValueError("pair membership is not a product")
        self._NR = NR

        # word-end slots as a flat static list, padded to >= num_records
        # so the per-frame records have a fixed shape
        we_n, we_h = np.nonzero(tree.we_exit_logp > LOG_ZERO / 2)
        pad = config.num_records - len(we_n)
        if pad > 0:
            we_n = np.concatenate([we_n, np.zeros(pad, dtype=we_n.dtype)])
            we_h = np.concatenate([we_h, np.zeros(pad, dtype=we_h.dtype)])
        n_real = len(we_n) - max(pad, 0)
        self.wordend = WordEnds(tree, lm, config, word_classes, self.device)
        we_word = tree.we_word[we_n, we_h]
        slot_lmid = self.wordend.lm_ids(we_word)
        members = lm_members(lm)
        self._K = len(members)
        self._log_coeffs = lm.log_coeffs if self._K > 1 else [0.0]
        # static (interpolated) unigram of each slot's LM word: with the
        # carried backoff weight, the cheap rank estimate of a word end
        uni_mix = np.full(len(we_n), -np.inf, np.float64)
        for m, lw in zip(members, self._log_coeffs):
            row = np.full(m.num_words, LOG_ZERO, np.float32)
            lo0, hi0 = int(m.state_first[0]), int(m.state_first[1])
            row[m.trans_word[lo0:hi0]] = m.trans_prob[lo0:hi0]
            uni_mix = np.logaddexp(uni_mix,
                                   lw + row[np.maximum(slot_lmid, 0)])
        uni_w = np.maximum(uni_mix, LOG_ZERO).astype(np.float32)
        we_skip = tree.we_skip_lm[we_n, we_h]
        we_exit = np.where(np.arange(len(we_n)) < n_real,
                           tree.we_exit_logp[we_n, we_h], LOG_ZERO)
        dur = node_duration_params(tree, model, config.duration_scale)
        self._has_durations = bool(np.any(duration_table(
            model, config.max_dur, config.duration_scale) != 0))
        # utterance-initial entries: the boundary-context pair row
        init_row = pt[tree.init_pair]
        init_lp = plp[tree.init_pair]

        ts = config.transition_scale_eff

        def dev(a, dtype=None):
            return torch.as_tensor(np.asarray(a), dtype=dtype,
                                   device=self.device)

        i64 = torch.int64
        t = {
            "pdf": dev(tree.pdf, i64),
            "grp_src": dev(grp_src, i64),
            "grp_inv": dev(grp_inv, i64),
            "left_mem": dev(left_mem),
            "first_mem": dev(first_mem),
            "entry_inv": dev(node_to_entry, i64),
            "we_node": dev(we_n, i64),
            "we_word": dev(we_word, i64),
            "we_lmid": dev(slot_lmid, i64),
            "we_uni": dev(uni_w),
            "we_pair": dev(tree.we_pair[we_n, we_h], i64),
            "we_exit": dev(we_exit.astype(np.float32)),
            "we_pron": dev(self.wordend.pron[we_n, we_h]),
            "we_skip": dev(we_skip),
            "we_skip_any": dev(we_skip | (we_word < 0)),
            "init_tgt": dev(init_row[init_lp > LOG_ZERO / 2], i64),
            "init_lp": dev(init_lp[init_lp > LOG_ZERO / 2]),
        }
        for key, v in dur.items():
            t[key] = dev(v)
            t["we_" + key] = dev(v[we_n])
        # transition terms scaled once (the same float32 products the
        # step would form)
        t["ts_self"] = ts * dev(shifts[0])
        t["ts_prev"] = ts * dev(shifts[1])
        t["ts_skip"] = ts * dev(shifts[2])
        t["ts_grp"] = ts * dev(grp_lp)
        t["ts_exit"] = ts * t["we_exit"]
        self.t = t
        # the node and beam kernels' tables, on a card
        self._kt = (dense_cuda.tables(t, grp_lp, config.max_dur,
                                      self._has_durations, NR)
                    if self.device.type == "cuda" else None)

    # -- pieces of the step ----------------------------------------------
    def _bo_est(self, states):
        """The carried backoff payload of the word-end rank estimate:
        min(bo_weight[state], 0), and for an interpolated LM the max over
        members of log coeff + that."""
        tables = self.wordend.tables
        if self._K == 1:
            return torch.clamp(tables["bo_weight"][states], max=0.0)
        st = self.lm.decode(states)
        est = None
        for k, tab in enumerate(tables):
            e = self._log_coeffs[k] + torch.clamp(
                tab["bo_weight"][st[..., k]], max=0.0)
            est = e if est is None else torch.maximum(est, e)
        return est

    def _dur_bonus(self, dur, prefix=""):
        """Gamma duration log-prob for staying ``dur + 1`` frames, from
        per-node (or per word-end slot) parameters."""
        t = self.t
        d = torch.clamp(dur + 1, 1, self.config.max_dur).float()
        return t[prefix + "dur_valid"] * (
            t[prefix + "dur_lncoef"] * torch.log(d)
            - d * t[prefix + "dur_invb"] + t[prefix + "dur_const"])

    def _step(self, state, obs, step_idx, v, n_frames, fin, lattice=False,
              spare=None, scr=None):
        """Frame ``step_idx + 1`` of obs [B, T, S] for [B, N] state arrays;
        ``v`` [B] says which rows it is valid for (``n_frames`` [B]).  The
        carried score is the total am + lm_scale*lms; dead nodes hold
        LOG_ZERO.  Phases 2 and 3 read only the old state, so they run
        first; then the node pass (phase 1, re-entry's fan-in and the
        observation) and the beam pass, as the CUDA kernels of
        `ops/dense_cuda.py` where the search has them (``spare``: the
        padded arrays the new state is written into; ``scr``: their
        scratch), else as the plain passes.  -> (new state, the frame's
        [B, E] records: (word, previous record) and, with ``lattice``,
        (am, lms) too; ``fin``, the best node's (rec, total, am, lms)
        where ``v``, else as it was)."""
        with span("dense.words"):
            cands, recs = self._words(state, step_idx, lattice)
        with span("dense.reentry"):
            reentry = self._reentry(*cands)
        freeze = self.config.require_sentence_end
        kt = self._kt
        with span("dense.arcs"):
            if kt is not None:
                new = dense_cuda.node_pass(kt, state, spare, obs, step_idx + 1,
                                           reentry, n_frames, freeze, scr)
            else:
                new, rowmax = self._node_pass_plain(
                    state, obs[:, step_idx + 1][:, self.t["pdf"]], reentry, v)
        with span("dense.beam"):
            if kt is not None:
                new, fin = dense_cuda.beam_pass(
                    new, n_frames, step_idx + 1, freeze, self.config.beam,
                    self.config.lm_scale_eff, fin, scr)
            else:
                new, fin = self._beam_pass_plain(new, rowmax, v, fin)
        return new, recs, fin

    def _words(self, state, step_idx, lattice):
        """Phase 2, word ends of the old state: a cheap static rank of all
        slots, the exact LM walk on the top E.  -> ((c_total, c_lms,
        lm_next, e_rec, c_alive, cand) of the E candidates, records)."""
        cfg = self.config
        t = self.t
        total, lms, lm, dur, rec, bo, _alive = state
        B = total.shape[0]
        E = cfg.num_records
        a_lm = cfg.lm_scale_eff
        ins = cfg.insertion_penalty_eff
        dvc = total.device
        wn = t["we_node"]                                     # [Nw]
        Nw = wn.shape[0]
        skip = t["we_skip_any"]
        tot_wn = total[:, wn]
        lms_wn = lms[:, wn]
        we_durb = self._dur_bonus(dur[:, wn], "we_")
        we_am = fma(tot_wn, lms_wn, -a_lm) + t["ts_exit"] + we_durb
        base_lms = lms_wn + t["we_pron"]
        appr_lm = torch.where(skip, 0.0, bo[:, wn] + t["we_uni"] + ins)
        slot_ok = ((tot_wn > LOG_ZERO / 2) & (t["we_exit"] > LOG_ZERO / 2)
                   & (skip | (t["we_lmid"] >= 0)))
        rank0 = torch.where(
            slot_ok,
            fma(tot_wn + t["ts_exit"] + we_durb, t["we_pron"] + appr_lm,
                a_lm),
            NEG_INF)
        k = min(E, Nw)
        cand = top_k(rank0, k)                                # [B, k]
        c_ok = slot_ok.gather(1, cand)
        if k < E:
            zpad = torch.zeros((B, E - k), dtype=cand.dtype, device=dvc)
            cand = torch.cat([cand, zpad], dim=1)
            c_ok = torch.cat([c_ok, zpad.bool()], dim=1)
        c_word = t["we_word"][cand]
        c_skip = skip[cand]
        c_state = lm[:, wn].gather(1, cand)
        with span("dense.lmwalk"):
            lm_next, lm_score = self.wordend.walk_words(
                c_state, c_word, t["we_lmid"][cand])
        lm_next, lm_score, c_lm_ok = self.wordend.commit(
            c_state, c_word, lm_next, lm_score, c_skip)
        c_am = we_am.gather(1, cand)
        c_lms = (base_lms.gather(1, cand) + lm_score
                 + torch.where(c_skip, 0.0, ins))
        c_alive = c_ok & c_lm_ok
        c_total = torch.where(c_alive, fma(c_am, c_lms, a_lm), NEG_INF)

        # records: the E candidates with exact scores
        c_prev = rec[:, wn].gather(1, cand)
        recs, e_rec = records(c_alive, c_word, c_prev, step_idx,
                              (c_am, c_lms) if lattice else ())
        return (c_total, c_lms, lm_next, e_rec, c_alive, cand), recs

    def _reentry(self, c_total, c_lms, lm_next, e_rec, c_alive, cand):
        """Phase 3's [B, C] part: the top C word ends and what each
        carries into its context-pair row.  -> (r_total, r_alive, r_pair,
        r_lms, r_lm, r_rec, r_bo), each [B, C]."""
        top_c = top_k(c_total, REENTRY_WIDTH)                 # [B, C]
        r_lms = c_lms.gather(1, top_c)
        r_lm = lm_next.gather(1, top_c)
        r_rec = e_rec.gather(1, top_c)
        r_alive = c_alive.gather(1, top_c)
        r_bo = self._bo_est(r_lm)
        r_pair = self.t["we_pair"][cand.gather(1, top_c)]
        r_total = torch.where(
            r_alive, torch.clamp(c_total.gather(1, top_c), min=LOG_ZERO),
            LOG_ZERO)
        return r_total, r_alive, r_pair, r_lms, r_lm, r_rec, r_bo

    def _node_pass_plain(self, state, obs_t, reentry, v):
        """The node pass in plain index ops: phase 1 (in-arc relaxation:
        shifts + grouped irregular arcs), re-entry's fan-in of
        ``reentry`` (`_reentry`) at the entry nodes, and the observation
        add, obs_t [B, N] gathered per node; with ``require_sentence_end``
        a row past its frames (``v`` false) keeps its old state.  ->
        (new state before the beam, the rows' maxima [B]: -inf at a
        kept row)."""
        t = self.t
        total, lms, lm, dur, rec, bo, _alive = state
        B, N = total.shape
        dvc = total.device

        # phase 1: in-arc relaxation
        cross = (total + self._dur_bonus(dur) if self._has_durations
                 else total)
        cand0 = total + t["ts_self"]
        cand1 = _shift(cross, 1, LOG_ZERO) + t["ts_prev"]
        cand2 = _shift(cross, 2, LOG_ZERO) + t["ts_skip"]
        gsrc = t["grp_src"]                                   # [Mi, F]
        g_best, fwin = (cross[:, gsrc] + t["ts_grp"]).max(dim=-1)
        src_win = gsrc[torch.arange(gsrc.shape[0], device=dvc)[None, :],
                       fwin]                                  # [B, Mi]
        inv_g = t["grp_inv"]

        def expand(vals, fill):
            """compact [B, Mi] -> [B, N] (nodes without irregular arcs get
            `fill`)"""
            pad = torch.full((B, 1), fill, dtype=vals.dtype, device=dvc)
            return torch.cat([vals, pad], dim=1)[:, inv_g]

        best3, choice = torch.stack([cand0, cand1, cand2]).max(dim=0)
        irr_sc = expand(g_best, LOG_ZERO)
        take_irr = irr_sc > best3
        best = torch.maximum(best3, irr_sc)

        def pick(x, fill):
            sel = torch.where(choice == 0, x, torch.where(
                choice == 1, _shift(x, 1, fill), _shift(x, 2, fill)))
            return torch.where(take_irr,
                               expand(x.gather(1, src_win), fill), sel)

        new_lms = pick(lms, 0.0)
        new_lm = pick(lm, 0)
        new_rec = pick(rec, -1)
        new_bo = pick(bo, 0.0)
        new_dur = torch.where(take_irr | (choice != 0),
                              torch.zeros_like(dur), dur + 1)
        new_alive = best > LOG_ZERO / 2

        # phase 3: the top C enter through their context-pair rows
        r_total, r_alive, r_pair, r_lms, r_lm, r_rec, r_bo = reentry
        NR = self._NR
        maskC = t["left_mem"][r_pair // NR] & t["first_mem"][r_pair % NR]
        enter = torch.where(maskC & r_alive[..., None], r_total[..., None],
                            LOG_ZERO)                         # [B, C, M]
        e_sc, winner = enter.max(dim=1)                       # [B, M]
        e_valid = e_sc > LOG_ZERO / 2

        def c_pay(vals):
            """the winning candidate's payload per entry node, plus the pad
            row of nodes outside the entry space"""
            out = torch.where(
                e_valid, vals.gather(1, winner),
                torch.zeros((), dtype=vals.dtype, device=dvc))
            return torch.cat([out, torch.zeros((B, 1), dtype=vals.dtype,
                                               device=dvc)], dim=1)

        inv = t["entry_inv"]
        e_sc1 = torch.cat([e_sc, torch.full((B, 1), LOG_ZERO, device=dvc)],
                          dim=1)
        cur = torch.where(new_alive, best, LOG_ZERO)
        sc_full = e_sc1[:, inv]
        take_tgt = sc_full > cur                              # [B, N]
        new_lms = torch.where(take_tgt, c_pay(r_lms)[:, inv], new_lms)
        new_lm = torch.where(take_tgt, c_pay(r_lm)[:, inv], new_lm)
        new_dur = torch.where(take_tgt, torch.zeros_like(new_dur), new_dur)
        new_rec = torch.where(take_tgt, c_pay(r_rec)[:, inv], new_rec)
        new_bo = torch.where(take_tgt, c_pay(r_bo)[:, inv], new_bo)
        new_alive = new_alive | take_tgt

        # phase 4's observation
        new_total = torch.where(take_tgt, sc_full, cur) + obs_t
        new = (new_total, new_lms, new_lm, new_dur, new_rec, new_bo,
               new_alive)
        rowmax = new_total.max(dim=1).values
        if self.config.require_sentence_end:
            new = tuple(torch.where(v[:, None], n, o)
                        for n, o in zip(new, state))
            rowmax = torch.where(v, rowmax, NEG_INF)
        return new, rowmax

    def _beam_pass_plain(self, state, rowmax, v, fin):
        """Phase 4's global beam on a node pass's ``state`` with its rows'
        maxima, and the frame's best node for ``fin`` (rec, total, am,
        lms), taken where ``v``; with ``require_sentence_end`` a row past
        its frames keeps its state.  -> (state, fin)."""
        total, lms, lm, dur, rec, bo, alive = state
        new_alive = alive & (total >= (rowmax - self.config.beam)[:, None])
        new_total = torch.where(new_alive, total, LOG_ZERO)
        # per-frame best snapshot (rec, total, am, lms)
        bestn = new_total.argmax(dim=1, keepdim=True)
        best_lms = lms.gather(1, bestn)[:, 0]
        new_fin = (rec.gather(1, bestn)[:, 0], rowmax,
                   fma(rowmax, best_lms, -self.config.lm_scale_eff),
                   best_lms)
        if self.config.require_sentence_end:
            new_alive = torch.where(v[:, None], new_alive, alive)
            new_total = torch.where(v[:, None], new_total, total)
        fin = tuple(torch.where(v, n, o) for n, o in zip(new_fin, fin))
        return (new_total, lms, lm, dur, rec, bo, new_alive), fin

    def _fin_of(self, state):
        total, lms, _lm, _dur, rec, _bo, alive = state
        total = torch.where(alive, total, NEG_INF)
        mx = total.max(dim=1).values
        isb = total == mx[:, None]
        best_rec = torch.where(isb, rec, torch.iinfo(torch.int64).min
                               ).max(dim=1).values
        best_lms = torch.where(isb, lms, NEG_INF).max(dim=1).values
        return (best_rec, mx, fma(mx, best_lms, -self.config.lm_scale_eff),
                best_lms)

    def _final_commit(self, state):
        """Final-frame choice with P(</s>|h) (require_sentence_end): the
        best node, or a word end committed at the final frame
        (entry-based word ids in the reference; no exit transition or
        duration on the commit).  -> (rec, total, am, lms, final word)"""
        cfg = self.config
        t = self.t
        we = self.wordend
        a_lm = cfg.lm_scale_eff
        tot, lms, lm, _dur, rec, _bo, alive = state
        B, N = tot.shape
        if we.end_id is not None:
            end_sc = we.end_score(lm)
            base_lms = lms + torch.where(alive, end_sc, 0.0)
            base_tot = tot + torch.where(alive, a_lm * end_sc, 0.0)
        else:
            base_lms, base_tot = lms, tot
        wn = t["we_node"]
        w_word = t["we_word"].expand(B, -1)
        w_ok = ((t["we_exit"] > LOG_ZERO / 2) & ~t["we_skip"]
                & (t["we_word"] >= 0) & (t["we_lmid"] >= 0)) & alive[:, wn]
        sc_w, end2, lm_ok = we.final_walk(lm[:, wn], w_word,
                                          t["we_lmid"].expand(B, -1))
        alt_lms = (lms[:, wn] + t["we_pron"] + cfg.insertion_penalty_eff
                   + sc_w + end2)
        alt_tot = torch.where(
            w_ok & lm_ok,
            fma(fma(tot[:, wn], lms[:, wn], -a_lm), alt_lms, a_lm), NEG_INF)
        base_total = torch.where(alive & we.base_ok, base_tot, NEG_INF)
        allt = torch.cat([base_total, alt_tot], dim=1)
        besti = allt.argmax(dim=1, keepdim=True)
        is_alt = besti >= N
        slot = (besti - N).clamp(min=0)
        bestn = torch.where(is_alt, wn[slot], besti)
        best_total = allt.gather(1, besti)
        best_lms = torch.where(is_alt, alt_lms.gather(1, slot),
                               base_lms.gather(1, bestn))
        fw_best = torch.where(is_alt, w_word.gather(1, slot), -1)
        return (rec.gather(1, bestn)[:, 0], best_total[:, 0],
                fma(best_total, best_lms, -a_lm)[:, 0], best_lms[:, 0],
                fw_best[:, 0])

    def _initial_state(self, obs, lm_init):
        """The [B, N] state arrays at frame 0 of obs [B, T, S]: the
        utterance-initial entries alive with their first observation."""
        t = self.t
        B = obs.shape[0]
        N = self.tree.num_nodes
        dvc = obs.device
        r_tgt = t["init_tgt"]
        first = obs[:, 0][:, t["pdf"][r_tgt]] + t["init_lp"]
        am0 = torch.full((B, N), LOG_ZERO, device=dvc).scatter_reduce(
            1, r_tgt.expand(B, -1), first, reduce="amax")
        alive0 = torch.zeros((B, N), dtype=torch.bool, device=dvc)
        alive0[:, r_tgt] = True
        lm0 = torch.full((B, N), lm_init, dtype=torch.int64, device=dvc)
        bo0 = self._bo_est(lm0)
        return (am0, torch.zeros((B, N), device=dvc), lm0,
                torch.zeros((B, N), dtype=torch.int64, device=dvc),
                torch.full((B, N), -1, dtype=torch.int64, device=dvc),
                bo0, alive0)

    def _decode(self, obs, n_frames, lm_init, lattice):
        """[B, T, S] obs, [B] frame counts -> final scalars and the
        [B, T-1, E] record arrays: (word id, previous record pointer) as
        one int64 [2, B, T-1, E] tensor and, with ``lattice``, (am, lms)
        as one [2, B, T-1, E] float tensor (bfloat16 with
        ``records_half``), else None."""
        cfg = self.config
        B, T, _ = obs.shape
        N = self.tree.num_nodes
        dvc = obs.device
        state = self._initial_state(obs, lm_init)
        # Without the final </s> update the result is the best node of
        # the last valid frame: snapshot it per frame and let the state
        # run on past n_frames.  Otherwise freeze the state at n_frames.
        snap = not cfg.require_sentence_end
        fin = self._fin_of(state)
        spare = scr = None
        if self._kt is not None:
            # the kernels' padded rows; the new state goes to the spare
            state = dense_cuda.padded(state)
            spare = dense_cuda.padded(state)
            scr = dense_cuda.Scratch(B, dvc)
            if obs.stride(2) != 1:
                obs = obs.contiguous()
        recs = [[] for _ in range(4 if lattice else 2)]
        # the least a frame moves: the carried state read once, written
        # once
        state_bytes = 2 * B * N * sum(x.element_size() for x in state)
        for i in range(T - 1):
            count("dense.state_bytes", state_bytes)
            count("dense.rows", B)
            with span("dense.step", i):
                v = (i + 1) < n_frames                       # [B]
                new_state, rows, fin = self._step(
                    state, obs, i, v, n_frames, fin, lattice, spare, scr)
                spare, state = state, new_state
                for lst, r, f in zip(recs, rows, NO_RECORD):
                    lst.append(torch.where(v[:, None], r, f))
        if snap:
            finals = fin + (torch.full((B,), -1, dtype=torch.int64,
                                       device=dvc),)
        else:
            finals = self._final_commit(state)
        stacked = stack_records(recs, B, cfg.num_records, dvc)
        rec_ints = torch.stack(stacked[:2])
        if not lattice:
            return finals, rec_ints, None
        rec_floats = torch.stack(stacked[2:])
        if cfg.records_half:
            rec_floats = rec_floats.to(torch.bfloat16)
        return finals, rec_ints, rec_floats

    # -- public API -------------------------------------------------------
    def decode(self, obs, n_frames=None, sentence_start="<s>",
               lattice=True) -> DecodeResult:
        """[T, S] state log-probs -> the 1-best result, with the records
        of a word graph unless ``lattice`` is false."""
        obs = torch.as_tensor(obs, dtype=torch.float32, device=self.device)
        if n_frames is None:
            n_frames = obs.shape[0]
        return self.decode_batch(obs[None], [n_frames], sentence_start,
                                 lattice=lattice)[0]

    def decode_batch(self, obs, n_frames, sentence_start="<s>",
                     lattice=True) -> list:
        """[B, T, S] state log-probs + [B] frame counts -> B results;
        with ``lattice`` each carries its records (`word_graph`).

        Spans (`utils/profiling.py`): ``dense.decode`` the call;
        ``dense.step`` each frame (its self time the state freeze and
        the record selection), with one child per phase of `_step`
        (``dense.arcs``, ``dense.words``, ``dense.reentry``,
        ``dense.beam``), and ``dense.lmwalk`` the exact LM walk inside
        ``dense.words``; ``dense.fetch`` (the host waits for finals and
        records) and ``dense.traceback``.  ``dense.arcs`` holds the node
        pass (phase 1, re-entry's fan-in, the observation), ``dense.reentry``
        re-entry's [B, C] part, ``dense.beam`` the beam pass.  Counters:
        ``dense.state_bytes``, per frame 2 x B x N x the bytes a node of
        the carried state holds, the least a frame reads and writes;
        ``dense.rows``, B a frame; ``dense.node_pass.rows``
        (`ops/dense_cuda.py`), B a launch of the node kernel, and
        ``dense.node.launches`` / ``dense.beam.launches``, one a launch."""
        with span("dense.decode"):
            obs = torch.as_tensor(obs, dtype=torch.float32, device=self.device)
            n = torch.as_tensor(np.asarray(n_frames), dtype=torch.int64,
                                device=self.device)
            finals, rec_ints, rec_floats = self._decode(
                obs, n, initial_code(self.lm, sentence_start), lattice)
            with span("dense.fetch"):
                finals = [f.cpu().numpy() for f in finals]
                recs = rec_ints.cpu().numpy()
                # bfloat16 records come back to float32 on the host
                rec_f = rec_floats.cpu().float().numpy() if lattice else None
            out = []
            if lattice:
                for b in range(obs.shape[0]):
                    out.append(DecodeResult(
                        search=self, final_ptr=int(finals[0][b]),
                        log_prob=float(finals[1][b]),
                        final_am=float(finals[2][b]),
                        final_lms=float(finals[3][b]), rec_words=recs[0, b],
                        rec_prevs=recs[1, b], rec_ams=rec_f[0, b],
                        rec_lmss=rec_f[1, b], final_word=int(finals[4][b])))
                return out
            wmax = min(self._traceback_cap, obs.shape[1])
            with span("dense.traceback"):
                for b in range(obs.shape[0]):
                    ids = traceback(recs[0, b], recs[1, b], int(finals[0][b]),
                                    int(finals[4][b]), wmax)
                    out.append(DecodeResult(
                        search=self, final_ptr=int(finals[0][b]),
                        log_prob=float(finals[1][b]),
                        final_am=float(finals[2][b]),
                        final_lms=float(finals[3][b]), rec_words=None,
                        rec_prevs=None, rec_ams=None, rec_lmss=None,
                        words=expand_word_boundaries(
                            [self.tree.vocab[i] for i in ids], self.config)))
            return out
