"""MPE/MPFE discriminative statistics (minimum phone/frame error).

Counterpart of `aaltoasr_tpu/train/mpe.py`, with an explicit batch axis
as `train/estep.py` has: observations [B, T, P], graph tables [B, ...]
(`estep.stack_graphs`), ``n_frames`` [B], and every gather batched.  The
frame recursions are Python loops into preallocated tensors with no
host synchronization inside them.

Reference: `aku/SegErrorEvaluator.{hh,cc}` custom path scores over
segmented lattices + `aku/HmmNetBaumWelch.hh:294` compute_custom_path_
scores, feeding MPE_NUM/MPE_DEN accumulators (`aku/stats.cc --mpe`).
Expected accuracies propagate with a first-order expectation semiring
alongside the standard forward-backward:

    A[t,p] = sum_f u_f A[t-1,src_f] + c[t,p]   (u = arrival posteriors)
    B[t,p] = sum_f v_f (B[t+1,tgt_f] + c[t+1,tgt_f])
    gamma_mpe[t,p] = gamma[t,p] * (A[t,p] + B[t,p] - C_avg)

Positive parts accumulate into the MPE numerator buffer, negative parts
into the denominator; the EBW M-step (train.ebw, mode='mpe') consumes
them.  The frame-level error modes (mpfe-pdf, mpfe-cps, mpfe) give a
local accuracy per (frame, position); the segment-level ones (mpe, mwe,
snfe) an accuracy per segment, through a duration-augmented state
(position, time in segment) and a host-built accuracy table.
"""

from __future__ import annotations

import numpy as np
import torch

from aaltoasr_tpu_torch.ops.logsemiring import LOG_ZERO, logaddexp, logsumexp
from aaltoasr_tpu_torch.train import estep
from aaltoasr_tpu_torch.train.estep import _take, _take_t, _valid


def _exp_w(v, ref):
    return torch.exp(torch.clamp(v - ref, min=-80.0))


def _live_w(v, ref):
    """`_exp_w` of the arcs that carry mass, 0 for dead arcs (v at
    LOG_ZERO).  The reference gives a dead arc into a dead state the
    weight exp(0) = 1 (LOG_ZERO absorbs the arc's own score in float32)
    and into a live one exp(-80): unreached states' expected accuracies
    then grow geometrically with the frames, leak into the live states
    through the exp(-80) floor, and on long utterances overflow until
    gamma_mpe is NaN."""
    return torch.where(v > LOG_ZERO / 2, _exp_w(v, ref),
                       torch.zeros((), device=v.device))


def mpe_forward_backward(obs_pos, graph, n_frames, accuracy):
    """FB with expected-accuracy propagation over [B, T, P].

    accuracy: [B, T, P] local accuracies c[t, p].
    Returns (gamma, gamma_mpe [B, T, P], total_ll [B], avg_accuracy [B]).
    Dead arcs carry no expected accuracy (`_live_w`).
    """
    B, T, P = obs_pos.shape
    dev = obs_pos.device
    in_src, in_logp = graph["in_src"], graph["in_logp"]
    out_tgt, out_logp = graph["out_tgt"], graph["out_logp"]
    valid = _valid(n_frames, T)
    final = estep._final(graph, P, dev)

    alphas = torch.empty((B, T, P), dtype=torch.float32, device=dev)
    As = torch.empty((B, T, P), dtype=torch.float32, device=dev)
    torch.clamp(obs_pos[:, 0] + estep._entry(graph, B, P, dev),
                min=LOG_ZERO, out=alphas[:, 0])
    As[:, 0] = accuracy[:, 0]
    for t in range(1, T):
        alpha, A = alphas[:, t - 1], As[:, t - 1]
        obs_t = obs_pos[:, t]
        contrib = _take(alpha, in_src) + in_logp                 # [B, P, F]
        new_alpha = torch.clamp(logsumexp(contrib, dim=2) + obs_t,
                                min=LOG_ZERO)
        # arrival posteriors per in-arc
        u = _live_w(contrib, (new_alpha - obs_t)[..., None])
        new_A = (u * _take(A, in_src)).sum(2) + accuracy[:, t]
        v = valid[:, t, None]
        torch.where(v, new_alpha, alpha, out=alphas[:, t])
        torch.where(v, new_A, A, out=As[:, t])

    alpha_T = alphas[:, T - 1]
    total = logsumexp(alpha_T + final, dim=1)
    gamma_last = _exp_w(alpha_T + final, total[:, None])
    avg_acc = (gamma_last * As[:, T - 1]).sum(1)

    betas = torch.empty((B, T, P), dtype=torch.float32, device=dev)
    Bs = torch.empty((B, T, P), dtype=torch.float32, device=dev)
    betas[:, T - 1] = final
    Bs[:, T - 1] = 0.0
    for t in range(T - 2, -1, -1):
        beta, Bn = betas[:, t + 1], Bs[:, t + 1]
        contrib = (out_logp + _take(obs_pos[:, t + 1], out_tgt)
                   + _take(beta, out_tgt))                      # [B, P, F]
        new_beta = torch.clamp(logsumexp(contrib, dim=2), min=LOG_ZERO)
        w = _live_w(contrib, new_beta[..., None])
        new_B = (w * (_take(Bn, out_tgt)
                      + _take(accuracy[:, t + 1], out_tgt))).sum(2)
        v = valid[:, t + 1, None]
        torch.where(v, new_beta, beta, out=betas[:, t])
        torch.where(v, new_B, Bn, out=Bs[:, t])

    gamma = torch.exp(torch.clamp(alphas + betas - total[:, None, None],
                                  min=-80.0))
    gamma = gamma * valid[:, :, None]
    gamma_mpe = gamma * (As + Bs - avg_acc[:, None, None])
    return gamma, gamma_mpe, total, avg_acc


def _position_scores(scorer, gll, pdf):
    """(cidx, clogw [B, P, K], gll_pk [B, T, P, K], state_obs [B, T, P]):
    each position's mixture on its K component columns."""
    cidx = scorer.comp_idx[pdf]
    clogw = scorer.comp_logw[pdf]
    gll_pk = _take_t(gll, cidx)
    return cidx, clogw, gll_pk, logsumexp(gll_pk + clogw[:, None], dim=-1)


def search_obs(scorer, gll, graph):
    """The search observations of ``graph``: state log-likelihoods plus
    the per-arc constants of hmmnet graphs."""
    obs = _position_scores(scorer, gll, graph["pdf"])[3]
    if "obs_const" in graph:
        obs = obs + graph["obs_const"][:, None, :]
    return obs


def gamma_to_stats(scorer, features, graph, gamma, gll=None):
    """Sufficient statistics from an arbitrary [B, T, P] occupancy
    (the accumulation half of `estep.chain_stats`).  Its feature count
    is one per (frame, component) whose responsibility passes 1e-10,
    not `chain_stats`' liveness rule.  ``gll``: the features' Gaussian
    log-likelihoods, when the caller has them."""
    pdf = graph["pdf"]
    B, T, D = features.shape
    P = pdf.shape[1]
    K = scorer.comp_idx.shape[1]
    Gp = scorer.score_matrix.shape[1]
    Sp = scorer.comp_idx.shape[0]
    if gll is None:
        gll = scorer.gaussian_log_likelihoods(features)
    cidx, clogw, gll_pk, state_obs = _position_scores(scorer, gll, pdf)
    log_resp = clogw[:, None] + gll_pk - state_obs[..., None]
    R_flat = (gamma[..., None] * torch.exp(torch.clamp(
        log_resp, min=-80.0))).reshape(B, T, P * K)
    del gll_pk, log_resp
    g_flat = cidx.reshape(B, P * K)
    c = R_flat.sum(1)
    RT = R_flat.transpose(1, 2)
    return {
        "gamma": estep._scatter_add(Gp, g_flat, c),
        "mean_acc": estep._scatter_add(Gp, g_flat, torch.bmm(RT, features)),
        "sec_acc": estep._scatter_add(Gp, g_flat,
                                      torch.bmm(RT, features * features)),
        "feacount": estep._scatter_add(
            Gp, g_flat, (R_flat > 1e-10).sum(1, dtype=torch.int64)),
        "mix_gamma": estep._scatter_add(Sp, pdf, c.reshape(B, P, K)),
    }


def _num_den(scorer, features, den_graph, gamma_mpe, gll):
    zero = torch.zeros((), device=gamma_mpe.device)
    return (gamma_to_stats(scorer, features, den_graph,
                           torch.maximum(gamma_mpe, zero), gll),
            gamma_to_stats(scorer, features, den_graph,
                           torch.maximum(-gamma_mpe, zero), gll))


def mpe_stats(scorer, features, num_graph, den_graph, n_frames,
              num_trans_slots: int, mode: str = "mpfe-pdf",
              membership=None):
    """Frame-error E-step of a batch (modes mpfe-pdf / mpfe-cps / mpfe;
    SegErrorEvaluator.cc:180-214).

    1. Viterbi over the numerator graph -> reference pdf/phone per frame
       (the shift-compiled Viterbi when the graph has its tables).
    2. Accuracy-augmented FB over the denominator graph.
    3. Positive/negative MPE occupancies -> num/den statistics.

    For mpfe-cps / mpfe the graphs must carry a "phone" table (model
    phone index per position) and ``membership`` the [n_phones,
    n_states] bool tensor of `phone_membership`.

    Returns dict(num=..., den=..., log_likelihood [B], avg_accuracy [B]).
    """
    features = features.float()
    T = features.shape[1]
    gll = scorer.gaussian_log_likelihoods(features)
    vit = (estep.masked_viterbi_shift if "sh_logp" in num_graph
           else estep.masked_viterbi)
    path, _ = vit(search_obs(scorer, gll, num_graph), num_graph, n_frames)
    ref_pdf = torch.gather(num_graph["pdf"], 1, path)           # [B, T]
    den_obs = search_obs(scorer, gll, den_graph)
    ref_phone = (torch.gather(num_graph["phone"], 1, path)
                 if mode != "mpfe-pdf" else None)
    accuracy = frame_accuracy(mode, den_graph["pdf"], den_graph.get("phone"),
                              ref_pdf, ref_phone, membership)
    accuracy = accuracy * _valid(n_frames, T)[:, :, None]
    _, gamma_mpe, total, avg_acc = mpe_forward_backward(
        den_obs, den_graph, n_frames, accuracy)
    num, den = _num_den(scorer, features, den_graph, gamma_mpe, gll)
    return {"num": num, "den": den, "log_likelihood": total,
            "avg_accuracy": avg_acc}


# ---------------------------------------------------------------------------
# Error modes (SegErrorEvaluator, aku/SegErrorEvaluator.{hh,cc})
#
# The reference implements 6 of its 9 enum modes (custom_score throws
# "not implemented" for MPFE_MONOPHONE_LABEL/STATE and
# MPFE_CONTEXT_LABEL, SegErrorEvaluator.cc:226-227):
#   frame-level:   mpfe-pdf, mpfe-cps, mpfe (= MPFE_HYP_CONTEXT_PHONE_
#                  STATE)  — local accuracy per (frame, position)
#   segment-level: mpe, mwe, snfe — accuracy per phone/word segment,
#                  computed here with a duration-augmented expectation
#                  semiring (state = (position, time-in-segment)).
# ---------------------------------------------------------------------------

def extract_center_phone(label: str) -> str:
    """Center phone of a context label (SegErrorEvaluator.cc:42-60)."""
    pos1 = label.rfind("-")
    pos2 = label.find("+")
    if pos2 < 0:
        pos2 = label.find(";", max(pos1, 0))
    if pos1 >= 0 and pos2 > pos1 + 1:
        temp = label[pos1 + 1:pos2]
    elif pos2 >= 0:
        temp = label[:pos2]
    elif pos1 >= 0:
        temp = label[pos1 + 1:]
    else:
        temp = label
    return temp if temp else label


def phone_membership(model) -> np.ndarray:
    """[n_phones, n_states] bool: state s belongs to phone q."""
    S = model.num_states
    M = np.zeros((len(model.phones), S), dtype=bool)
    for q, phone in enumerate(model.phones):
        for s in phone.states:
            M[q, s] = True
    return M


def frame_accuracy(mode: str, hyp_pdf, hyp_phone, ref_pdf, ref_phone,
                   membership):
    """[B, T, P] local accuracies for the frame-level modes, from the
    hypothesis tables [B, P] and the reference alignment [B, T].

    mpfe-pdf: hyp pdf equals the reference pdf (MPFE_PDF).
    mpfe-cps: hyp pdf is A state of the reference's context phone
              (MPFE_CONTEXT_PHONE_STATE, SegErrorEvaluator.cc:189-200).
    mpfe:     reference pdf is a state of the hyp position's phone
              (MPFE_HYP_CONTEXT_PHONE_STATE, .cc:201-214).
    """
    if mode == "mpfe-pdf":
        return (hyp_pdf[:, None, :] == ref_pdf[:, :, None]).float()
    M = torch.as_tensor(membership, device=hyp_pdf.device)
    if mode == "mpfe-cps":
        return M[ref_phone[:, :, None], hyp_pdf[:, None, :]].float()
    if mode == "mpfe":
        return M[hyp_phone[:, None, :], ref_pdf[:, :, None]].float()
    raise ValueError(f"unknown frame error mode {mode!r}")


def segment_accuracy_table(mode: str, ref_segs, n_frames: int,
                           max_dur: int, num_classes: int,
                           pad_frames: int | None = None):
    """ACC[t1, dur, c]: accuracy of a hypothesis segment of class c
    covering frames [t1-dur, t1).  Host NumPy (per utterance).

    ref_segs: list of (start, end, class) with end exclusive.
    mpe/mwe: max over overlapping refs of -1 + (1+same)*e/len_ref
    (SegErrorEvaluator.cc:154-177); snfe: sum over overlapping refs of
    -e/min(dur, len_ref) for mismatches (.cc:215-231).

    Rows past n_frames replicate row n_frames so frozen padded steps
    see the utterance-final accuracies.

    The reference updates all C classes for each reference segment; a
    class no segment names gets the same values as every other such
    class, so those are computed once, and a named class follows the
    reference's operations (snfe's sums in its order; mpe's maxima,
    exact in any order): the table is the reference's, in O(segments)
    passes over [T+1, D+1] (snfe: O(segments x named classes)) instead
    of O(segments x C).
    """
    Tp = (pad_frames if pad_frames is not None else n_frames)
    D = max_dur
    t1 = np.arange(Tp + 1)[:, None]           # [T+1, 1]
    dur = np.arange(D + 1)[None, :]           # [1, D+1] (index = dur)
    t0 = t1 - dur
    maxed = mode in ("mpe", "mwe")
    named = sorted({rc for _, _, rc in ref_segs})
    base = np.full((Tp + 1, D + 1), -1.0 if maxed else 0.0, np.float64)
    own = {c: base.copy() for c in named}
    for (rs, re, rc) in ref_segs:
        e = np.minimum(t1, re) - np.maximum(t0, rs)       # [T+1, D+1]
        e = np.maximum(e, 0).astype(np.float64)
        if maxed:
            rlen = max(re - rs, 1)
            other = -1.0 + e / rlen
            same = -1.0 + 2.0 * e / rlen
            # maxima: exact in any order, so a named class takes the
            # classless maximum at the end
            base = np.maximum(base, np.where(e > 0, other, -np.inf))
            own[rc] = np.maximum(own[rc], np.where(e > 0, same, -np.inf))
        else:  # snfe
            n = np.minimum(np.maximum(dur, 1), max(re - rs, 1))
            err = -e / n
            base += err
            for c in named:
                own[c] += err
            own[rc] -= err                          # no error when same
    acc = np.repeat(base[:, :, None], num_classes, axis=2)
    for c in named:
        acc[:, :, c] = np.maximum(own[c], base) if maxed else own[c]
    # dur = 0 is never a real segment
    acc[:, 0, :] = 0.0
    if n_frames < Tp:
        acc[n_frames + 1:] = acc[n_frames]
    return acc.astype(np.float32)


def _table_at(acc_t, dmin, cls):
    """acc_t [B, D+1, C] at (dmin [D], cls [B, ...]) -> [B, ..., D]."""
    C = acc_t.shape[2]
    idx = dmin * C + cls[..., None]
    return _take(acc_t.reshape(acc_t.shape[0], -1), idx)


def mpe_forward_backward_seg(obs_pos, graph, n_frames, acc_table, cls,
                             max_dur: int):
    """Segment-accuracy FB: expectation semiring over the duration-
    augmented state (position, time-in-segment), [B, P, D] per step.

    obs_pos: [B, T, P]; acc_table: [B, T+1, D+1, C] (T the padded frame
    count: the last step and the final commit read rows 1..T); cls:
    [B, P] class per position; segments = maximal runs of graph["inst"].
    Returns (gamma [B, T, P], gamma_mpe [B, T, P], total [B],
    avg_accuracy [B]).  Dead arcs carry no expected accuracy
    (`_live_w`): the reference's overflow on long utterances is kept out.
    """
    B, T, P = obs_pos.shape
    D = max_dur
    dev = obs_pos.device
    in_src, in_logp = graph["in_src"], graph["in_logp"]
    out_tgt, out_logp = graph["out_tgt"], graph["out_logp"]
    inst = graph["inst"]
    inst_src, inst_tgt = _take(inst, in_src), _take(inst, out_tgt)
    live_in, live_out = in_logp > LOG_ZERO / 2, out_logp > LOG_ZERO / 2
    same_in = ((inst_src == inst[:, :, None]) & live_in)[..., None]
    cross_in = ((inst_src != inst[:, :, None]) & live_in)[..., None]
    same_out = ((inst_tgt == inst[:, :, None]) & live_out)[..., None]
    cross_out = ((inst_tgt != inst[:, :, None]) & live_out)[..., None]
    cls_src = _take(cls, in_src)                                # [B, P, F]
    d_idx = torch.arange(D, device=dev)
    dmin = torch.clamp(d_idx + 1, max=D)
    nxt_d = torch.clamp(d_idx + 1, max=D - 1)
    lz = torch.full((), LOG_ZERO, device=dev)
    valid = _valid(n_frames, T)

    def rows(x, idx):
        """x [B, P, D] at positions idx [B, P, F] -> [B, P, F, D]."""
        Fw = idx.shape[2]
        flat = idx.reshape(B, P * Fw, 1).expand(B, P * Fw, D)
        return torch.gather(x, 1, flat).view(B, P, Fw, D)

    alphas = torch.empty((B, T, P, D), dtype=torch.float32, device=dev)
    As = torch.empty((B, T, P, D), dtype=torch.float32, device=dev)
    alphas[:, 0] = LOG_ZERO
    torch.clamp(obs_pos[:, 0] + estep._entry(graph, B, P, dev),
                min=LOG_ZERO, out=alphas[:, 0, :, 0])
    As[:, 0] = 0.0
    w_in = in_logp[..., None]
    for t in range(1, T):
        alpha, A = alphas[:, t - 1], As[:, t - 1]             # [B, P, D]
        a_src, A_src = rows(alpha, in_src), rows(A, in_src)   # [B, P, F, D]
        # same instance: d -> d+1 (saturating at D-1)
        sv = torch.where(same_in, a_src + w_in, lz)
        tv = torch.cat([torch.full_like(sv[..., :1], LOG_ZERO),
                        sv[..., :-1]], dim=3)     # target slot d <- d-1
        tc = torch.cat([torch.zeros_like(A_src[..., :1]), A_src[..., :-1]],
                       dim=3)
        ov_v = sv[..., D - 1]                     # overflow -> slot D-1
        ov_c = A_src[..., D - 1]
        # cross instance: commit the source segment, land at d = 0
        cv = torch.where(cross_in, a_src + w_in, lz)
        cc = A_src + _table_at(acc_table[:, t], dmin, cls_src)

        lse_same = logsumexp(tv, dim=2)                       # [B, P, D]
        slotD = logaddexp(lse_same[..., D - 1], logsumexp(ov_v, dim=2))
        lse0 = logsumexp(cv.reshape(B, P, -1), dim=2)
        # the reference's write order: slot D-1, then slot 0 (D=1)
        pre = lse_same.clone()
        pre[..., D - 1] = slotD
        pre[..., 0] = lse0
        new_alpha = torch.clamp(pre + obs_pos[:, t, :, None], min=LOG_ZERO)

        u_same = _live_w(tv, pre[:, :, None, :])
        u_ov = _live_w(ov_v, pre[:, :, None, D - 1])
        u0 = _live_w(cv, pre[:, :, None, 0:1])
        new_A = (u_same * tc).sum(2)
        new_A[..., D - 1] += (u_ov * ov_c).sum(2)
        new_A[..., 0] = (u0 * cc).reshape(B, P, -1).sum(2)

        v = valid[:, t, None, None]
        torch.where(v, new_alpha, alpha, out=alphas[:, t])
        torch.where(v, new_A, A, out=As[:, t])

    final = estep._final(graph, P, dev)
    final_commit = _table_at(acc_table[:, T], dmin, cls)      # [B, P, D]
    fin = alphas[:, T - 1] + final[..., None]
    total = logsumexp(fin.reshape(B, -1), dim=1)
    gamma_last = _exp_w(fin, total[:, None, None])
    avg_acc = (gamma_last * (As[:, T - 1] + final_commit)).sum((1, 2))

    betas = torch.empty((B, T, P, D), dtype=torch.float32, device=dev)
    Bs = torch.empty((B, T, P, D), dtype=torch.float32, device=dev)
    betas[:, T - 1] = final[..., None]
    Bs[:, T - 1] = final_commit
    for t in range(T - 2, -1, -1):
        beta, Bc = betas[:, t + 1], Bs[:, t + 1]
        b_tgt, B_tgt = rows(beta, out_tgt), rows(Bc, out_tgt)
        w = (out_logp + _take(obs_pos[:, t + 1], out_tgt))[..., None]
        # same: (p, d) -> (q, min(d+1, D-1))
        sv = torch.where(same_out, w + b_tgt[..., nxt_d], lz)
        sc = B_tgt[..., nxt_d]
        # cross: commit p's segment (duration d+1 ending at t+1); the
        # value is d-independent (destination slot 0) but carries a
        # d-dependent committed accuracy
        cv = torch.where(cross_out, w + b_tgt[..., 0:1], lz).expand_as(sv)
        commit = _table_at(acc_table[:, t + 1], dmin, cls)    # [B, P, D]
        cc = B_tgt[..., 0:1] + commit[:, :, None, :]
        pre = logsumexp(torch.cat([sv, cv], dim=2), dim=2)
        new_beta = torch.clamp(pre, min=LOG_ZERO)
        new_B = (_live_w(sv, pre[:, :, None, :]) * sc
                 + _live_w(cv, pre[:, :, None, :]) * cc).sum(2)
        v = valid[:, t + 1, None, None]
        torch.where(v, new_beta, beta, out=betas[:, t])
        torch.where(v, new_B, Bc, out=Bs[:, t])

    g3 = _exp_w(alphas + betas, total[:, None, None, None])
    g3 = g3 * valid[:, :, None, None]
    del alphas, betas
    gamma = g3.sum(3)
    gamma_mpe = (g3 * (As + Bs - avg_acc[:, None, None, None])).sum(3)
    return gamma, gamma_mpe, total, avg_acc


def mpe_stats_seg(scorer, features, num_graph, den_graph, n_frames,
                  num_trans_slots: int, acc_table, cls, max_dur: int):
    """Segment-mode MPE/MWE/SNFE E-step of a batch: accuracy-augmented
    FB over the denominator graph with a precomputed segment accuracy
    table (host-built from the numerator alignment)."""
    features = features.float()
    gll = scorer.gaussian_log_likelihoods(features)
    _, gamma_mpe, total, avg_acc = mpe_forward_backward_seg(
        search_obs(scorer, gll, den_graph), den_graph, n_frames,
        acc_table, cls, max_dur)
    num, den = _num_den(scorer, features, den_graph, gamma_mpe, gll)
    return {"num": num, "den": den, "log_likelihood": total,
            "avg_accuracy": avg_acc}


def ref_segments_from_path(path, inst, cls, n_frames: int):
    """Host: (start, end, class) runs of the numerator Viterbi path."""
    path = np.asarray(path)[:n_frames]
    pinst = np.asarray(inst)[path]
    pcls = np.asarray(cls)[path]
    segs = []
    start = 0
    for t in range(1, len(path)):
        if pinst[t] != pinst[t - 1]:
            segs.append((start, t, int(pcls[t - 1])))
            start = t
    if len(path):
        segs.append((start, len(path), int(pcls[-1])))
    return segs
