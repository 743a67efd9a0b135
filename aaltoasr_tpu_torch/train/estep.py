"""Baum-Welch / Viterbi E-step over a batch of utterances on the device —
the replacement for the `stats` worker's inner loops
(`aku/stats.cc:73-257` simple_train).

Counterpart of `aaltoasr_tpu/train/estep.py`, with an explicit batch
axis where the reference vmaps one utterance: features [B, T, D], graph
tables [B, ...] (`stack_graphs`), ``n_frames`` [B], and every gather is
a batched `torch.gather`.  Pipeline: per-Gaussian log-likelihoods (one
product) -> masked forward-backward (or Viterbi) over the padded
position graph -> component responsibilities -> sufficient statistics
via [P*K, T] x [T, D] products and scatter-adds.  Frames at or past an
utterance's ``n_frames`` are inert: the recursions freeze there, so one
padded shape serves a whole bucket.

The forward and backward recursions are Python frame loops that write
into preallocated [B, T, P] tensors and never synchronize with the host;
the transition posteriors need no loop (each frame's term is
independent) and run as one vectorized pass over time, in chunks.
Scatter-adds on the GPU use atomics, so sums change order from run to
run: compare statistics within tolerance.  Products run in IEEE float32
(TF32 off).

Graphs of HMM networks (`mpv` mode, the per-arc feacount of the
discriminative path) belong to the hmmnet half of training and raise
`NotImplementedError`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F_

from aaltoasr_tpu_torch.ops.logsemiring import LOG_ZERO, logsumexp

HMMNET_ITEM = "ROADMAP queue 1 item 5: training, its hmmnet half"

# elements of one float32 intermediate of the vectorized transition pass
_CHUNK_ELEMS = 1 << 25

# fill values for the graph arrays whose length differs between
# utterances (`shift_compile`'s irregular-edge lists)
_PAD_FILL = {"ir_logp": LOG_ZERO}


def later(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet ({HMMNET_ITEM})")


def stack_graphs(graphs: list, device) -> dict:
    """Stack per-utterance graph dicts (numpy, from `pad_chain` /
    `shift_compile`) on the host and upload them once: [B, ...] tensors,
    integer tables as int64.  Arrays whose length differs between the
    utterances (the irregular-edge lists) are padded with inert edges:
    source and target 0, weight LOG_ZERO, slot 0."""
    out = {}
    for k in graphs[0]:
        vals = [np.asarray(g[k]) for g in graphs]
        n = max((v.shape[0] for v in vals if v.ndim), default=0)
        vals = [np.concatenate([v, np.full((n - v.shape[0],) + v.shape[1:],
                                           _PAD_FILL.get(k, 0), v.dtype)])
                if v.ndim and v.shape[0] < n else v for v in vals]
        arr = np.stack(vals)
        arr = (arr.astype(np.int64) if np.issubdtype(arr.dtype, np.integer)
               else arr.astype(np.float32))
        out[k] = torch.as_tensor(arr, device=device)
    return out


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, P] gathered at idx [B, ...] -> [B, ...] (``x[b, idx[b]]``)."""
    B = idx.shape[0]
    return torch.gather(x, 1, idx.reshape(B, -1)).view(idx.shape)


def _take_t(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, T, P] gathered at idx [B, ...] for every frame -> [B, T, ...]."""
    B, T = x.shape[:2]
    flat = idx.reshape(B, 1, -1).expand(B, T, -1)
    return torch.gather(x, 2, flat).view((B, T) + tuple(idx.shape[1:]))


def _scatter_add(n: int, idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Per-utterance segment sum: src [B, E, ...] onto idx [B, E] -> [B, n, ...]."""
    B = idx.shape[0]
    full = idx.view((B, -1) + (1,) * (src.dim() - 2)).expand_as(src)
    return torch.zeros((B, n) + tuple(src.shape[2:]), dtype=src.dtype,
                       device=src.device).scatter_add_(1, full, src)


def _valid(n_frames: torch.Tensor, T: int) -> torch.Tensor:
    return (torch.arange(T, device=n_frames.device)[None, :]
            < n_frames[:, None])                               # [B, T]


def _entry(graph, B, P, device):
    """Entry log-prob vectors [B, P]: explicit (hmmnet graphs) or
    position 0 (transcript chains)."""
    if "entry" in graph:
        return graph["entry"]
    e = torch.where(torch.arange(P, device=device) == 0,
                    torch.zeros((), device=device),
                    torch.full((), LOG_ZERO, device=device))
    return e.expand(B, P)


def _final(graph, P, device):
    """Final log-prob vectors [B, P]: explicit or each chain's last
    position."""
    if "final" in graph:
        return graph["final"]
    last = (torch.arange(P, device=device)[None, :]
            == graph["num_positions"][:, None] - 1)
    return torch.where(last, graph["final_logp"][:, None],
                       torch.full((), LOG_ZERO, device=device))


def _add_final_slot(trans_post: torch.Tensor, graph) -> torch.Tensor:
    if "final_slot" in graph:
        trans_post = trans_post.scatter_add(
            1, graph["final_slot"][:, None],
            torch.ones_like(trans_post[:, :1]))
    return trans_post


def _chunks(T1: int, per_frame: int):
    step = max(1, _CHUNK_ELEMS // max(per_frame, 1))
    for s in range(0, T1, step):
        yield s, min(T1, s + step)


def masked_forward_backward(obs_pos, graph, n_frames, num_trans_slots: int,
                            with_transitions: bool = True,
                            with_live: bool = False):
    """FB over [B, T_pad, P] with frames >= n_frames inert.

    Returns (gamma [B, T, P] linear, trans_post [B, NT], total_ll [B]).
    with_transitions=False skips the transition posteriors.
    with_live=True appends a STRUCTURAL liveness mask [B, T, P] (alpha
    and beta both reachable, in log space before the exp clamp).
    """
    B, T, P = obs_pos.shape
    dev = obs_pos.device
    in_src, in_logp = graph["in_src"], graph["in_logp"]
    in_slot = graph["in_slot"]
    out_tgt, out_logp = graph["out_tgt"], graph["out_logp"]
    valid = _valid(n_frames, T)

    alphas = torch.empty((B, T, P), dtype=torch.float32, device=dev)
    torch.clamp(obs_pos[:, 0] + _entry(graph, B, P, dev), min=LOG_ZERO,
                out=alphas[:, 0])
    for t in range(1, T):
        alpha = alphas[:, t - 1]
        new = logsumexp(_take(alpha, in_src) + in_logp, dim=2) + obs_pos[:, t]
        new = torch.clamp(new, min=LOG_ZERO)
        torch.where(valid[:, t, None], new, alpha, out=alphas[:, t])

    beta_last = _final(graph, P, dev)
    total = logsumexp(alphas[:, T - 1] + beta_last, dim=1)

    betas = torch.empty((B, T, P), dtype=torch.float32, device=dev)
    betas[:, T - 1] = beta_last
    for t in range(T - 2, -1, -1):
        beta = betas[:, t + 1]
        contrib = (out_logp + _take(obs_pos[:, t + 1], out_tgt)
                   + _take(beta, out_tgt))
        new = torch.clamp(logsumexp(contrib, dim=2), min=LOG_ZERO)
        torch.where(valid[:, t + 1, None], new, beta, out=betas[:, t])

    gamma = torch.exp(torch.clamp(alphas + betas - total[:, None, None],
                                  min=-80.0))
    gamma = gamma * valid[:, :, None]

    trans_post = torch.zeros((B, num_trans_slots), dtype=torch.float32,
                             device=dev)
    if with_transitions and T > 1:
        # masked frames select 0 (the reference multiplies by the mask,
        # so a term that overflows there gives inf * 0 = NaN)
        zero = torch.zeros((), device=dev)
        Fn = in_src.shape[2]
        acc = torch.zeros((B, P, Fn), dtype=torch.float32, device=dev)
        for s, e in _chunks(T - 1, B * P * Fn):
            xi = (_take_t(alphas[:, s:e], in_src) + in_logp[:, None]
                  + obs_pos[:, s + 1:e + 1, :, None]
                  + betas[:, s + 1:e + 1, :, None]
                  - total[:, None, None, None])
            acc += torch.where(valid[:, s + 1:e + 1, None, None],
                               torch.exp(torch.clamp(xi, min=-80.0)),
                               zero).sum(1)
        trans_post = _scatter_add(num_trans_slots, in_slot.reshape(B, -1),
                                  acc.reshape(B, -1))
    trans_post = _add_final_slot(trans_post, graph)
    if with_live:
        live = ((alphas > LOG_ZERO / 2) & (betas > LOG_ZERO / 2)
                & valid[:, :, None])
        return gamma, trans_post, total, live
    return gamma, trans_post, total


def _backtrace(end_pos, valid, prev_of):
    """Path [B, T] from the last frame's positions back: ``prev_of(t,
    pos)`` gives the predecessor at frame t of ``pos`` at frame t+1;
    masked frames replay their position.  A device loop (no host sync)."""
    B, T = valid.shape
    path = torch.empty((B, T), dtype=torch.int64, device=end_pos.device)
    path[:, T - 1] = end_pos
    pos = end_pos
    for t in range(T - 2, -1, -1):
        pos = torch.where(valid[:, t + 1], prev_of(t, pos), pos)
        path[:, t] = pos
    return path


def masked_viterbi(obs_pos, graph, n_frames):
    """Viterbi over [B, T_pad, P]; returns (path [B, T] positions,
    score [B]).  Frames >= n_frames replay the final state (mask before
    use).  Ties take the first fan-in slot and the first end position
    (`torch.max`/`torch.argmax` return the first maximum, as
    `jnp.argmax` does)."""
    B, T, P = obs_pos.shape
    dev = obs_pos.device
    in_src, in_logp = graph["in_src"], graph["in_logp"]
    Fn = in_src.shape[2]
    valid = _valid(n_frames, T)

    alpha = torch.clamp(obs_pos[:, 0] + _entry(graph, B, P, dev),
                        min=LOG_ZERO)
    bps = torch.zeros((B, max(T - 1, 0), P), dtype=torch.int64, device=dev)
    for t in range(1, T):
        best, bp = torch.max(_take(alpha, in_src) + in_logp, dim=2)
        new = torch.clamp(best + obs_pos[:, t], min=LOG_ZERO)
        v = valid[:, t, None]
        alpha = torch.where(v, new, alpha)
        torch.where(v, bp, torch.zeros_like(bp), out=bps[:, t - 1])
    final_v = alpha + _final(graph, P, dev)
    end_pos = torch.argmax(final_v, dim=1)
    score = torch.gather(final_v, 1, end_pos[:, None])[:, 0]
    src_flat = in_src.reshape(B, P * Fn)

    def prev_of(t, pos):
        f = torch.gather(bps[:, t], 1, pos[:, None])[:, 0]
        return torch.gather(src_flat, 1, (pos * Fn + f)[:, None])[:, 0]

    return _backtrace(end_pos, valid, prev_of), score


def chain_stats(scorer, features, graph, n_frames, num_trans_slots: int,
                mode: str = "bw", full_stats: bool = False,
                arc_feacount: bool = False):
    """The E-step of a batch; returns a dict of per-utterance statistics
    with a leading batch axis.

    mode: 'bw' (Baum-Welch posteriors, `-M bw`), 'vit' (Viterbi one-hot,
    `-M vit`; `aku/stats.cc:341`).  Keys: gamma [B, Gp], mean_acc
    [B, Gp, D], sec_acc [B, Gp, D], feacount [B, Gp], mix_gamma
    [B, Sp, K], mix_ll [B, Sp], trans_acc [B, NT], log_likelihood [B],
    num_frames [B]; with full_stats also sec_acc_full [B, Gp, D, D].
    """
    if mode == "mpv":
        raise later("multipath Viterbi statistics (-M mpv)")
    if arc_feacount:
        raise later("per-arc feacounts of the discriminative path")
    pdf = graph["pdf"]                                    # [B, P]
    B, T, D = features.shape
    P = pdf.shape[1]
    K = scorer.comp_idx.shape[1]
    Gp = scorer.score_matrix.shape[1]
    Sp = scorer.comp_idx.shape[0]
    dev = features.device
    features = features.float()

    gll = scorer.gaussian_log_likelihoods(features)       # [B, T, Gp]
    cidx = scorer.comp_idx[pdf]                           # [B, P, K]
    clogw = scorer.comp_logw[pdf]                         # [B, P, K]
    # the states the chain visits, scored on their P*K component columns
    # (the reference's all-state path for P >= Sp gives the same
    # elements and reduction; the responsibilities need this gather
    # anyway)
    gll_pk = _take_t(gll, cidx)                           # [B, T, P, K]
    state_obs = logsumexp(gll_pk + clogw[:, None], dim=-1)   # [B, T, P]
    obs_pos = state_obs
    if "obs_const" in graph:
        # hmmnet graphs: per-arc static score + ln(transition prob)
        obs_pos = obs_pos + graph["obs_const"][:, None, :]

    valid = _valid(n_frames, T)
    live = None
    if mode == "bw":
        fb = (masked_forward_backward_shift if "sh_logp" in graph
              else masked_forward_backward)
        gamma, trans_post, total = fb(
            obs_pos, graph, n_frames, num_trans_slots,
            with_transitions="arc_slot" not in graph)
    elif mode == "vit":
        vit = (masked_viterbi_shift if "sh_logp" in graph
               else masked_viterbi)
        path, total = vit(obs_pos, graph, n_frames)
        gamma = F_.one_hot(path, P).float() * valid[:, :, None]
        live = gamma > 0.5
        trans_post = (torch.zeros((B, num_trans_slots), device=dev)
                      if "arc_slot" in graph else
                      _viterbi_transition_counts(
                          path, graph, n_frames, num_trans_slots))
    else:
        raise ValueError(f"unknown segmentation mode {mode!r}")

    if "arc_slot" in graph:
        # arc-synchronous graphs: every frame spent on a position IS a
        # traversal of its transition slot
        trans_post = _scatter_add(num_trans_slots, graph["arc_slot"],
                                  gamma.sum(1))

    # component responsibilities within each position's mixture:
    # log resp[t, p, k] = logw + gll[t, cidx] - sll[t, pdf] (the pure
    # state likelihood, not the const-shifted search observation)
    log_resp = clogw[:, None] + gll_pk - state_obs[..., None]
    R = gamma[..., None] * torch.exp(torch.clamp(log_resp, min=-80.0))
    R_flat = R.reshape(B, T, P * K)                        # [B, T, P*K]
    del gll, gll_pk, log_resp, R

    g_flat = cidx.reshape(B, P * K)
    c = R_flat.sum(1)                                     # [B, P*K]
    RT = R_flat.transpose(1, 2)                           # [B, P*K, T]
    gamma_g = _scatter_add(Gp, g_flat, c)
    m1 = _scatter_add(Gp, g_flat, torch.bmm(RT, features))
    m2 = _scatter_add(Gp, g_flat, torch.bmm(RT, features * features))
    m2_full = None
    if full_stats:
        # full second moments: one [P*K, T] x [T, D^2] product
        # (PDF_ML_FULL_STATS; FullStatisticsAccumulator)
        outer = (features[..., :, None]
                 * features[..., None, :]).reshape(B, T, D * D)
        m2_full = _scatter_add(Gp, g_flat, torch.bmm(RT, outer)).reshape(
            B, Gp, D, D)
    # feacount: one count per live (frame, pdf) pair, for every real
    # component of the state (`HmmNetBaumWelch::next_frame` pdf map,
    # `Gaussian::accumulate`); live means above the exp(-80) clamp floor
    # ~1.8e-35 of structurally dead positions
    if live is None:
        live = gamma > 1e-32
    pres = _scatter_add(Sp, pdf, live.float().transpose(1, 2))  # [B, Sp, T]
    frames_s = (pres > 0).sum(2)                                 # [B, Sp]
    real_comp = scorer.comp_logw > LOG_ZERO / 2                  # [Sp, K]
    per_comp = torch.where(real_comp, frames_s[:, :, None],
                           torch.zeros((), dtype=frames_s.dtype, device=dev))
    feacount = _scatter_add(Gp, scorer.comp_idx.reshape(1, -1).expand(B, -1),
                            per_comp.reshape(B, Sp * K))
    mix_gamma = _scatter_add(Sp, pdf, c.reshape(B, P, K))         # [B, Sp, K]
    # mixture log-likelihood accumulator: gamma * ln(state likelihood)
    # (Mixture::accumulate `mixture_ll`, Distributions.cc:2150-2153)
    mix_ll = _scatter_add(Sp, pdf, (gamma * state_obs).sum(1))

    out = {
        "gamma": gamma_g, "mean_acc": m1, "sec_acc": m2,
        "feacount": feacount, "mix_gamma": mix_gamma, "mix_ll": mix_ll,
        "trans_acc": trans_post, "log_likelihood": total,
        "num_frames": n_frames.to(torch.int64),
    }
    if m2_full is not None:
        out["sec_acc_full"] = m2_full
    return out


def _viterbi_transition_counts(path, graph, n_frames, num_trans_slots):
    """Count taken transitions along Viterbi paths onto slots -> [B, NT]."""
    in_src, in_slot = graph["in_src"], graph["in_slot"]
    B, T = path.shape
    Fn = in_src.shape[2]
    src = path[:, :-1]
    tgt = path[:, 1:]
    rows = tgt[:, :, None].expand(B, T - 1, Fn)
    # which in-edge of tgt has source == src (first match)
    match = torch.gather(in_src, 1, rows) == src[:, :, None]    # [B, T-1, F]
    f = torch.argmax(match.to(torch.int32), dim=2)
    slots = torch.gather(torch.gather(in_slot, 1, rows), 2, f[:, :, None])
    ok = ((torch.arange(1, T, device=path.device)[None, :]
           < n_frames[:, None]) & match.any(2))
    counts = _scatter_add(num_trans_slots, slots[:, :, 0], ok.float())
    return _add_final_slot(counts, graph)


def batch_chain_stats(scorer, features, graphs, n_frames,
                      num_trans_slots: int, mode: str = "bw"):
    """`chain_stats` over a padded batch, summed over the batch.

    features [B, T, D]; graphs: dict of stacked tables [B, ...];
    n_frames [B]."""
    stats = chain_stats(scorer, features, graphs, n_frames,
                        num_trans_slots, mode)
    return {k: v.sum(0) for k, v in stats.items()}


# ---------------------------------------------------------------------------
# shift-compiled forward-backward: positions are numbered phone-locally,
# so nearly every edge has target - source in {0, 1, 2}; those relax as
# array shifts (elementwise steps, no gather).  Remaining edges form a
# compact irregular list handled by one small gather + scatter-logsumexp
# per step.  The reference introduced it because dynamic gathers were
# slow on its device; both forms are kept, and the driver calls this one
# as the reference's does.
# ---------------------------------------------------------------------------

def shift_compile(graph: dict) -> dict:
    """Host: split a padded graph's in-edges into shift classes.

    Returns the graph dict extended with:
      sh_logp [3, P]  — in-edge weight from p-d for d in {0,1,2}
      sh_slot [3, P]  — transition slot of that edge
      ir_src/ir_tgt/ir_logp/ir_slot [Ei] — leftover edges
    """
    in_src = np.asarray(graph["in_src"])
    in_logp = np.asarray(graph["in_logp"])
    in_slot = np.asarray(graph["in_slot"])
    P, F = in_src.shape
    sh_logp = np.full((3, P), LOG_ZERO, np.float32)
    sh_slot = np.zeros((3, P), np.int32)
    ir_src, ir_tgt, ir_logp, ir_slot = [], [], [], []
    for p in range(P):
        for f in range(F):
            s = int(in_src[p, f])
            w = float(in_logp[p, f])
            if w <= LOG_ZERO / 2:
                continue
            d = p - s
            if d in (0, 1, 2) and sh_logp[d, p] <= LOG_ZERO / 2:
                sh_logp[d, p] = w
                sh_slot[d, p] = in_slot[p, f]
            else:
                ir_src.append(s)
                ir_tgt.append(p)
                ir_logp.append(w)
                ir_slot.append(int(in_slot[p, f]))
    if not ir_src:
        ir_src, ir_tgt = [0], [0]
        ir_logp, ir_slot = [LOG_ZERO], [0]
    out = dict(graph)
    out["sh_logp"] = np.asarray(sh_logp)
    out["sh_slot"] = np.asarray(sh_slot)
    out["ir_src"] = np.asarray(ir_src, np.int32)
    out["ir_tgt"] = np.asarray(ir_tgt, np.int32)
    out["ir_logp"] = np.asarray(ir_logp, np.float32)
    out["ir_slot"] = np.asarray(ir_slot, np.int32)
    return out


def _sh(x, d, fill):
    """x[..., p-d] with fill for p < d (shift toward higher indices)."""
    if not d:
        return x
    return F_.pad(x[..., :-d], (d, 0), value=fill)


def _sh_back(x, d, fill):
    """x[..., p+d] with fill past the end."""
    if not d:
        return x
    return F_.pad(x[..., d:], (0, d), value=fill)


def _scatter_lse(contrib, tgt, P):
    """Log-sum-exp scatter of contrib [B, E] onto targets [B, E] -> [B, P]."""
    B = contrib.shape[0]
    mx = torch.full((B, P), LOG_ZERO, dtype=contrib.dtype,
                    device=contrib.device).scatter_reduce(
        1, tgt, contrib, "amax", include_self=True)
    live = contrib > LOG_ZERO / 2
    term = torch.where(live, torch.exp(contrib - torch.gather(mx, 1, tgt)),
                       torch.zeros((), device=contrib.device))
    sums = torch.zeros((B, P), dtype=contrib.dtype,
                       device=contrib.device).scatter_add_(1, tgt, term)
    return torch.where(sums > 0,
                       mx + torch.log(torch.clamp(sums, min=1e-30)),
                       torch.full((), LOG_ZERO, device=contrib.device))


def _lse4(a, b, c, d):
    m = torch.maximum(torch.maximum(a, b), torch.maximum(c, d))
    m_safe = torch.clamp(m, min=LOG_ZERO)
    s = (torch.exp(a - m_safe) + torch.exp(b - m_safe)
         + torch.exp(c - m_safe) + torch.exp(d - m_safe))
    return torch.where(m > LOG_ZERO / 2,
                       m_safe + torch.log(torch.clamp(s, min=1e-30)),
                       torch.full((), LOG_ZERO, device=a.device))


def masked_forward_backward_shift(obs_pos, graph, n_frames,
                                  num_trans_slots: int,
                                  with_transitions: bool = True,
                                  with_live: bool = False):
    """Shift-structured FB; same contract as masked_forward_backward.

    The transition statistics accumulate per (position, shift class)
    and per irregular edge, and hit transition slots with one scatter at
    the end.
    """
    B, T, P = obs_pos.shape
    dev = obs_pos.device
    w0, w1, w2 = (graph["sh_logp"][:, d] for d in range(3))     # [B, P]
    ir_src, ir_tgt = graph["ir_src"], graph["ir_tgt"]
    ir_logp = graph["ir_logp"]
    valid = _valid(n_frames, T)

    alphas = torch.empty((B, T, P), dtype=torch.float32, device=dev)
    torch.clamp(obs_pos[:, 0] + _entry(graph, B, P, dev), min=LOG_ZERO,
                out=alphas[:, 0])
    for t in range(1, T):
        alpha = alphas[:, t - 1]
        c0 = alpha + w0
        c1 = _sh(alpha, 1, LOG_ZERO) + w1
        c2 = _sh(alpha, 2, LOG_ZERO) + w2
        cir = _scatter_lse(_take(alpha, ir_src) + ir_logp, ir_tgt, P)
        new = torch.clamp(_lse4(c0, c1, c2, cir) + obs_pos[:, t],
                          min=LOG_ZERO)
        torch.where(valid[:, t, None], new, alpha, out=alphas[:, t])

    beta_last = _final(graph, P, dev)
    total = logsumexp(alphas[:, T - 1] + beta_last, dim=1)

    # backward: out-edge of q with shift d has weight w_d[q+d]
    betas = torch.empty((B, T, P), dtype=torch.float32, device=dev)
    betas[:, T - 1] = beta_last
    for t in range(T - 2, -1, -1):
        beta = betas[:, t + 1]
        t_ob = obs_pos[:, t + 1] + beta              # [B, P] target term
        c0 = w0 + t_ob
        c1 = _sh_back(w1 + t_ob, 1, LOG_ZERO)
        c2 = _sh_back(w2 + t_ob, 2, LOG_ZERO)
        cir = _scatter_lse(ir_logp + _take(t_ob, ir_tgt), ir_src, P)
        new = torch.clamp(_lse4(c0, c1, c2, cir), min=LOG_ZERO)
        torch.where(valid[:, t + 1, None], new, beta, out=betas[:, t])

    gamma = torch.exp(torch.clamp(alphas + betas - total[:, None, None],
                                  min=-80.0))
    gamma = gamma * valid[:, :, None]

    trans_post = torch.zeros((B, num_trans_slots), dtype=torch.float32,
                             device=dev)
    if with_transitions:
        zero = torch.zeros((), device=dev)   # masked frames: see above
        Ei = ir_src.shape[1]
        acc_sh = torch.zeros((B, 3, P), dtype=torch.float32, device=dev)
        acc_ir = torch.zeros((B, Ei), dtype=torch.float32, device=dev)
        for s, e in _chunks(T - 1, B * (4 * P + 2 * Ei)):
            a_t = alphas[:, s:e]
            t_ob = (obs_pos[:, s + 1:e + 1] + betas[:, s + 1:e + 1]
                    - total[:, None, None])
            v = valid[:, s + 1:e + 1, None]
            for d, w in enumerate((w0, w1, w2)):
                x = torch.exp(torch.clamp(
                    _sh(a_t, d, LOG_ZERO) + w[:, None] + t_ob, min=-80.0))
                acc_sh[:, d] += torch.where(v, x, zero).sum(1)
            xir = torch.exp(torch.clamp(
                _take_t(a_t, ir_src) + ir_logp[:, None]
                + _take_t(t_ob, ir_tgt), min=-80.0))
            acc_ir += torch.where(v, xir, zero).sum(1)
        trans_post = _scatter_add(
            num_trans_slots,
            torch.cat([graph["sh_slot"].reshape(B, -1), graph["ir_slot"]],
                      dim=1),
            torch.cat([acc_sh.reshape(B, -1), acc_ir], dim=1))
    trans_post = _add_final_slot(trans_post, graph)
    if with_live:
        live = ((alphas > LOG_ZERO / 2) & (betas > LOG_ZERO / 2)
                & valid[:, :, None])
        return gamma, trans_post, total, live
    return gamma, trans_post, total


def masked_viterbi_shift(obs_pos, graph, n_frames):
    """Shift-structured Viterbi; same contract as masked_viterbi.

    Backpointers store the winning shift class (0/1/2) or 3 + the
    irregular winner; the backtrace resolves them against the static
    tables.  Ties keep the reference's rules: the first shift class
    among equal maxima, and the LARGEST edge index among the irregular
    edges that reach a target's maximum.
    """
    B, T, P = obs_pos.shape
    dev = obs_pos.device
    w0, w1, w2 = (graph["sh_logp"][:, d] for d in range(3))
    ir_src, ir_tgt = graph["ir_src"], graph["ir_tgt"]
    ir_logp = graph["ir_logp"]
    Ei = ir_src.shape[1]
    valid = _valid(n_frames, T)
    eidx = torch.arange(Ei, device=dev).expand(B, Ei)
    zero = torch.zeros((), dtype=torch.int64, device=dev)

    alpha = torch.clamp(obs_pos[:, 0] + _entry(graph, B, P, dev),
                        min=LOG_ZERO)
    chs = torch.zeros((B, max(T - 1, 0), P), dtype=torch.int64, device=dev)
    wins = torch.zeros((B, max(T - 1, 0), P), dtype=torch.int64, device=dev)
    stacked = torch.empty((B, 4, P), dtype=torch.float32, device=dev)
    for t in range(1, T):
        torch.add(alpha, w0, out=stacked[:, 0])
        torch.add(_sh(alpha, 1, LOG_ZERO), w1, out=stacked[:, 1])
        torch.add(_sh(alpha, 2, LOG_ZERO), w2, out=stacked[:, 2])
        contrib = _take(alpha, ir_src) + ir_logp                 # [B, Ei]
        cir = torch.full((B, P), LOG_ZERO, device=dev).scatter_reduce(
            1, ir_tgt, contrib, "amax", include_self=True)
        stacked[:, 3] = cir
        win = torch.zeros((B, P), dtype=torch.int64, device=dev).scatter_reduce(
            1, ir_tgt,
            torch.where(contrib >= torch.gather(cir, 1, ir_tgt), eidx, zero),
            "amax", include_self=True)
        best, choice = torch.max(stacked, dim=1)
        new = torch.clamp(best + obs_pos[:, t], min=LOG_ZERO)
        v = valid[:, t, None]
        alpha = torch.where(v, new, alpha)
        torch.where(v, choice, zero, out=chs[:, t - 1])
        torch.where(v, win, zero, out=wins[:, t - 1])
    final_v = alpha + _final(graph, P, dev)
    end_pos = torch.argmax(final_v, dim=1)
    score = torch.gather(final_v, 1, end_pos[:, None])[:, 0]

    def prev_of(t, pos):
        c = torch.gather(chs[:, t], 1, pos[:, None])[:, 0]
        w = torch.gather(wins[:, t], 1, pos[:, None])
        irr = torch.gather(ir_src, 1, w)[:, 0]
        return torch.where(c == 3, irr, pos - c)

    return _backtrace(end_pos, valid, prev_of), score
