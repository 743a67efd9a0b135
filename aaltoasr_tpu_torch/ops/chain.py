"""Viterbi and forward-backward over one utterance's position graph.

Counterpart of `aaltoasr_tpu/ops/chain.py`.  The reference fills an
explicit (frame x position) lattice with windowing (`aku/Viterbi.cc:356`
fill, `:296` compute_best_path); here each pass is a frame loop over
the padded fan-in tables of `models.hmm.pad_chain` that writes into a
preallocated [T, P] tensor (gather + small-axis reduction per frame, no
beams, no windowing).  The transition posteriors need no loop: every
frame's term is independent, so they are one vectorized pass over time.
`forward_assoc_chain` is the same forward pass as a log-depth prefix
scan of [P, P] log-matmul combines.

All functions take ``obs_pos`` = per-position observation log-likelihoods
[T, P] (``state_ll[:, pdf]`` gathered by the caller) and the graph dict
(numpy arrays or tensors; they are moved to ``obs_pos``'s device).  The
batched, masked forms that the E-step runs are in `train/estep.py`.
"""

from __future__ import annotations

import numpy as np
import torch

from aaltoasr_tpu_torch.ops.logsemiring import LOG_ZERO, logsumexp


def _tables(graph, device, *names):
    out = []
    for n in names:
        v = torch.as_tensor(np.asarray(graph[n]) if not isinstance(
            graph[n], torch.Tensor) else graph[n], device=device)
        out.append(v.long() if not v.is_floating_point() else v.float())
    return out


def _entry_vector(P, device):
    return torch.where(torch.arange(P, device=device) == 0,
                       torch.zeros((), device=device),
                       torch.full((), LOG_ZERO, device=device))


def _final_vector(P, num_positions, final_logp, device):
    return torch.where(torch.arange(P, device=device) == num_positions - 1,
                       torch.as_tensor(final_logp, dtype=torch.float32,
                                       device=device),
                       torch.full((), LOG_ZERO, device=device))


def viterbi_chain(obs_pos: torch.Tensor, graph):
    """Dense Viterbi over a chain graph.

    Returns (path [T] int64 positions, total score).  Equivalent of
    Viterbi::fill + compute_best_path with the forced start at position 0
    and forced end at the last position (`aku/Viterbi.cc:296-392`).
    Ties take the first fan-in slot (``torch.max`` returns the first
    maximum, as ``jnp.argmax`` does).
    """
    T, P = obs_pos.shape
    dev = obs_pos.device
    in_src, in_logp = _tables(graph, dev, "in_src", "in_logp")
    nump = int(np.asarray(graph["num_positions"]))
    alpha = torch.clamp(obs_pos[0] + _entry_vector(P, dev), min=LOG_ZERO)
    bps = torch.zeros((max(T - 1, 0), P), dtype=torch.int64, device=dev)
    for t in range(1, T):
        best, bps[t - 1] = torch.max(alpha[in_src] + in_logp, dim=1)
        alpha = torch.clamp(best + obs_pos[t], min=LOG_ZERO)
    final = alpha + _final_vector(P, nump, graph["final_logp"], dev)
    end_pos = nump - 1
    score = final[end_pos]
    path = torch.empty(T, dtype=torch.int64, device=dev)
    path[T - 1] = end_pos
    pos = torch.full((), end_pos, dtype=torch.int64, device=dev)
    for t in range(T - 2, -1, -1):
        pos = in_src[pos, bps[t, pos]]
        path[t] = pos
    return path, score


def forward_backward_chain(obs_pos: torch.Tensor, graph,
                           num_trans_slots: int):
    """Dense forward-backward; returns (gamma [T, P], trans_post [NT],
    total log-likelihood).

    gamma are linear-domain posteriors; trans_post accumulates transition
    posteriors onto TransitionTable slots (the .phs statistics).  The final
    exit transition of the utterance is accounted by `final_slot` (set by
    the caller via graph["final_slot"], posterior 1).
    """
    T, P = obs_pos.shape
    dev = obs_pos.device
    in_src, in_logp, in_slot, out_tgt, out_logp = _tables(
        graph, dev, "in_src", "in_logp", "in_slot", "out_tgt", "out_logp")
    nump = int(np.asarray(graph["num_positions"]))

    alphas = torch.empty((T, P), dtype=torch.float32, device=dev)
    alphas[0] = torch.clamp(obs_pos[0] + _entry_vector(P, dev),
                            min=LOG_ZERO)
    for t in range(1, T):
        new = logsumexp(alphas[t - 1][in_src] + in_logp, dim=1) + obs_pos[t]
        torch.clamp(new, min=LOG_ZERO, out=alphas[t])

    beta_T = _final_vector(P, nump, graph["final_logp"], dev)
    total = logsumexp(alphas[T - 1] + beta_T, dim=0)

    betas = torch.empty((T, P), dtype=torch.float32, device=dev)
    betas[T - 1] = beta_T
    for t in range(T - 2, -1, -1):
        # beta[t, p] = logsum_f out_logp[p,f] + obs[t+1, tgt] + beta[t+1, tgt]
        contrib = out_logp + obs_pos[t + 1][out_tgt] + betas[t + 1][out_tgt]
        torch.clamp(logsumexp(contrib, dim=1), min=LOG_ZERO, out=betas[t])

    gamma = torch.exp(torch.clamp(alphas + betas - total, min=-80.0))

    # transition posteriors: xi[t, p, f] for arrival at frame t+1
    xi = (alphas[:-1][:, in_src] + in_logp + obs_pos[1:, :, None]
          + betas[1:, :, None] - total)
    xi = torch.exp(torch.clamp(xi, min=-80.0)).sum(0)
    trans_post = torch.zeros(num_trans_slots, dtype=torch.float32,
                             device=dev).index_add_(
        0, in_slot.reshape(-1), xi.reshape(-1))
    # final exit transition: taken with posterior gamma[T-1, last] (== 1)
    if graph.get("final_slot", None) is not None:
        fs = int(np.asarray(graph["final_slot"]))
        trans_post[fs] += gamma[T - 1, nump - 1]
    return gamma, trans_post, total


def dense_transition_matrix(graph, device="cpu") -> torch.Tensor:
    """[P, P] log-transition matrix M[i, j] = log p(j -> i) from the
    padded fan-in tables (duplicate arcs logaddexp-accumulated)."""
    in_src = np.asarray(graph["in_src"].cpu() if isinstance(
        graph["in_src"], torch.Tensor) else graph["in_src"])
    in_logp = np.asarray(graph["in_logp"].cpu() if isinstance(
        graph["in_logp"], torch.Tensor) else graph["in_logp"])
    P = in_src.shape[0]
    M = np.full((P, P), -np.inf)
    for i in range(P):
        for f in range(in_src.shape[1]):
            lp = in_logp[i, f]
            if lp > LOG_ZERO / 2:
                M[i, in_src[i, f]] = np.logaddexp(M[i, in_src[i, f]], lp)
    return torch.as_tensor(np.maximum(M, LOG_ZERO), dtype=torch.float32,
                           device=device)


def _log_matmul(b: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """(b (.) a)[..., i, j] = logsum_k b[..., i, k] + a[..., k, j]."""
    return logsumexp(b[..., :, :, None] + a[..., None, :, :], dim=-2)


def forward_assoc_chain(obs_pos: torch.Tensor, graph, trans_dense=None):
    """Forward pass as a log-semiring matrix prefix scan over time.

    alpha_t = (A_t (.) ... (.) A_1) alpha_0 with A_t[i, j] =
    trans[j->i] + obs_t[i] and (B (.) A)[i, j] = logsum_k B[i,k] +
    A[k,j].  The reference's `associative_scan` becomes a log-depth
    (Hillis-Steele) loop: at distance d = 1, 2, 4, ... every prefix at
    t >= d takes in the prefix ending d steps earlier, one batched
    [P, P] log-matmul per round.  Cost O(T log T P^3) against the
    sequential scan's O(T P^2): it pays only where the time axis must be
    split (hour-scale audio) or P is small.  Returns (alphas [T, P],
    total log-likelihood).
    """
    T, P = obs_pos.shape
    dev = obs_pos.device
    if trans_dense is None:
        trans_dense = dense_transition_matrix(graph, dev)
    nump = int(np.asarray(graph["num_positions"]))
    alpha0 = torch.clamp(obs_pos[0] + _entry_vector(P, dev), min=LOG_ZERO)

    # A_t for t = 1..T-1
    prefixes = trans_dense[None, :, :] + obs_pos[1:, :, None]   # [T-1, P, P]
    d = 1
    while d < prefixes.shape[0]:
        combined = _log_matmul(prefixes[d:], prefixes[:-d])
        prefixes = torch.cat([prefixes[:d], combined], dim=0)
        d *= 2
    alphas_tail = logsumexp(prefixes + alpha0[None, None, :], dim=-1)
    alphas = torch.cat([alpha0[None], alphas_tail], dim=0)
    alphas = torch.clamp(alphas, min=LOG_ZERO)
    beta_T = _final_vector(P, nump, graph["final_logp"], dev)
    total = logsumexp(alphas[-1] + beta_T, dim=0)
    return alphas, total


def occupancies_from_alignment(path: torch.Tensor, P: int) -> torch.Tensor:
    """One-hot gamma from a Viterbi path: [T, P] (PhnReader-style fixed
    segmentation, `aku/PhnReader.cc` next_frame semantics)."""
    return torch.nn.functional.one_hot(path.long(), P).float()
