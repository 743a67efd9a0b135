"""Plain Baum-Welch statistics of transcript chains (`stats -M bw`).

Each utterance's chain is its phones' states in order.  A state either
stays (its offset-0 transition) or moves to the next position (offset
1, across phone ends too); the chain starts in its first position, and
the last phone's exit probability is applied after the last frame
(`aku/HmmSet.cc:258-271`).  The forward-backward runs in the log
domain over the padded batch; then per utterance the frame-state
occupancies split over each state's components by their posteriors and
accumulate the per-Gaussian occupancy and first and second moment
sums, and the per-state occupancy.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.gmm import Gmm

NEG = float("-inf")


def chain(task: dict, labels: list) -> tuple[np.ndarray, np.ndarray,
                                              np.ndarray, float]:
    """(state per position, log stay, log move, log exit of the last
    position) of a transcript."""
    pdf, stay, move = [], [], []
    for lbl in labels:
        for s in task["phones"][lbl]:
            tr = dict(task["transitions"][s])
            pdf.append(s)
            stay.append(np.log(tr.get(0, 0.0) or 1e-300))
            move.append(np.log(tr.get(1, 0.0) or 1e-300))
    return (np.asarray(pdf, np.int64), np.asarray(stay),
            np.asarray(move), float(move[-1]))


def stats(task: dict, gmm: Gmm, feats: list, transcripts: list,
          device) -> dict:
    """Statistics of utterances ([T, D] features in the GMM's dtype,
    phone-label transcripts): ``utt_ll`` [B] (each utterance's
    log-likelihood) and the summed ``state_occ`` [S], ``gauss_occ`` [G],
    ``mean_acc`` [G, D], ``sec_acc`` [G, D], as float64 numpy."""
    dt = gmm.dtype
    B = len(feats)
    chains = [chain(task, t) for t in transcripts]
    T = torch.as_tensor([f.shape[0] for f in feats], device=device)
    T_max = int(T.max())
    P_max = max(len(c[0]) for c in chains)
    obs = torch.full((B, T_max, P_max), NEG, dtype=dt, device=device)
    stay = torch.full((B, P_max), NEG, dtype=dt, device=device)
    move = torch.full((B, P_max), NEG, dtype=dt, device=device)
    last = torch.zeros(B, dtype=torch.int64, device=device)
    exit_lp = torch.zeros(B, dtype=dt, device=device)
    sll = []
    for b, (pdf, st, mv, ex) in enumerate(chains):
        P = len(pdf)
        s = gmm.state_ll(feats[b])                               # [T, S]
        sll.append(s)
        obs[b, :feats[b].shape[0], :P] = s[:, torch.as_tensor(pdf,
                                                              device=device)]
        stay[b, :P] = torch.as_tensor(st, dtype=dt, device=device)
        move[b, :P - 1] = torch.as_tensor(mv[:-1], dtype=dt, device=device)
        last[b] = P - 1
        exit_lp[b] = ex

    def shift_right(x):           # x[p - 1] at p, -inf at 0
        return torch.cat([torch.full_like(x[:, :1], NEG), x[:, :-1]], 1)

    def shift_left(x):            # x[p + 1] at p, -inf at the end
        return torch.cat([x[:, 1:], torch.full_like(x[:, :1], NEG)], 1)

    alpha = torch.empty((B, T_max, P_max), dtype=dt, device=device)
    a = torch.full((B, P_max), NEG, dtype=dt, device=device)
    a[:, 0] = obs[:, 0, 0]
    alpha[:, 0] = a
    for t in range(1, T_max):
        a = torch.logaddexp(a + stay, shift_right(a + move)) + obs[:, t]
        alpha[:, t] = a
    ar = torch.arange(B, device=device)
    ll = alpha[ar, T - 1, last] + exit_lp                         # [B]
    end = torch.full((B, P_max), NEG, dtype=dt, device=device)
    end[ar, last] = exit_lp
    beta = torch.empty_like(alpha)
    bt = end.clone()
    for t in range(T_max - 1, -1, -1):
        if t < T_max - 1:
            nxt = torch.logaddexp(stay + obs[:, t + 1] + bt,
                                  move + shift_left(obs[:, t + 1] + bt))
            bt = torch.where((t >= T - 1)[:, None], end, nxt)
        beta[:, t] = bt
    gamma = torch.exp(alpha + beta - ll[:, None, None])           # [B, T, P]

    S = gmm.comp.shape[0]
    G, D = gmm.A.shape[1], gmm.A.shape[0] // 2
    out = {"state_occ": torch.zeros(S, dtype=dt, device=device),
           "gauss_occ": torch.zeros(G, dtype=dt, device=device),
           "mean_acc": torch.zeros((G, D), dtype=dt, device=device),
           "sec_acc": torch.zeros((G, D), dtype=dt, device=device)}
    for b, (pdf, *_rest) in enumerate(chains):
        Tb, P = int(T[b]), len(pdf)
        x = feats[b].to(dt)
        occ = torch.zeros((Tb, S), dtype=dt, device=device)
        occ.index_add_(1, torch.as_tensor(pdf, device=device),
                       gamma[b, :Tb, :P])
        g = gmm.gaussian_ll(x)                                    # [Tb, G]
        post = torch.exp(g[:, gmm.comp] + gmm.logw
                         - sll[b][:, :, None])                    # [Tb, S, K]
        occ_g = torch.zeros((Tb, G), dtype=dt, device=device)
        occ_g.index_add_(1, gmm.comp.reshape(-1),
                         (occ[:, :, None] * post).reshape(Tb, -1))
        out["state_occ"] += occ.sum(0)
        out["gauss_occ"] += occ_g.sum(0)
        out["mean_acc"] += occ_g.T @ x
        out["sec_acc"] += occ_g.T @ (x * x)
    res = {k: v.double().cpu().numpy() for k, v in out.items()}
    res["utt_ll"] = ll.double().cpu().numpy()
    return res
