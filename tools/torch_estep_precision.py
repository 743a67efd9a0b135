"""How far the float32 forward-backward's posteriors stray at length.

    python3 tools/torch_estep_precision.py [--T 1000 (>= 512)] [--device cpu]

Runs the port's masked forward-backward (`train/estep.py`), plain and
shift-compiled, on one utterance of bench.py's `estep_fps` point (model
G=10,000, S=2,500, K=8, D=39; a 256-label chain of 512 positions;
N(0, 2) features) and a float64 forward-backward on the same state
log-likelihoods, and prints, per form, the total log-likelihood, the
largest |gamma - gamma64| of a (frame, position) cell and the frames'
occupancy range, then the largest spread of the summed statistics
between the two float32 forms relative to their scale.  The reference's
recursion is the same float32 log-domain one, so its posteriors stray as
far.  ~10 s on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from aaltoasr_tpu_torch.models.hmm import (  # noqa: E402
    TransitionTable, build_chain, pad_chain)
from aaltoasr_tpu_torch.ops.gmm import GmmScorer  # noqa: E402
from aaltoasr_tpu_torch.synth import random_model  # noqa: E402
from aaltoasr_tpu_torch.train import estep  # noqa: E402
from aaltoasr_tpu_torch.train.driver import fetch  # noqa: E402


def _lse(x, axis):
    m = np.max(x, axis=axis, keepdims=True)
    return np.squeeze(m, axis) + np.log(np.sum(np.exp(x - m), axis=axis))


def forward_backward64(obs, g):
    """Float64 FB over [T, P] observations and a padded chain graph."""
    T, P = obs.shape
    in_src, in_logp = g["in_src"], g["in_logp"].astype(np.float64)
    out_tgt, out_logp = g["out_tgt"], g["out_logp"].astype(np.float64)
    last = int(g["num_positions"]) - 1
    al = np.full((T, P), -1e30)
    al[0, 0] = obs[0, 0]
    for t in range(1, T):
        al[t] = np.maximum(_lse(al[t - 1][in_src] + in_logp, 1) + obs[t],
                           -1e30)
    be = np.full((T, P), -1e30)
    be[T - 1, last] = float(g["final_logp"])
    for t in range(T - 2, -1, -1):
        be[t] = np.maximum(_lse(out_logp + obs[t + 1][out_tgt]
                                + be[t + 1][out_tgt], 1), -1e30)
    total = al[T - 1, last] + float(g["final_logp"])
    return np.exp(np.maximum(al + be - total, -80.0)), total


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="torch_estep_precision")
    p.add_argument("--T", type=int, default=1000)
    p.add_argument("--device", default="cpu")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    model = random_model(G=10000, S=2500, D=39, K=8)
    table = TransitionTable.from_model(model)
    scorer = GmmScorer.from_model(model, device=dev)
    chain = build_chain(model, table, [f"p{i % 1250}" for i in range(256)])
    pad = pad_chain(chain, 512, fan=4)
    if args.T < chain.num_positions:
        p.error(f"--T must be at least the chain's {chain.num_positions} "
                "positions")
    x = torch.as_tensor(np.random.default_rng(0).normal(
        0, 2, (1, args.T, 39)).astype(np.float32), device=dev)
    n = torch.tensor([args.T], device=dev)
    g1 = estep.stack_graphs([pad], dev)
    gll = scorer.gaussian_log_likelihoods(x)
    sll = torch.logsumexp(gll[..., scorer.comp_idx] + scorer.comp_logw, -1)
    obs = estep._take_t(sll, g1["pdf"])                      # [1, T, P]
    gamma64, total64 = forward_backward64(
        obs[0].double().cpu().numpy(), pad)
    print(f"T={args.T} on {dev}: float64 log-likelihood {total64:.4f}")
    stats = {}
    for name, g in (("plain", pad), ("shift", estep.shift_compile(pad))):
        fb = (estep.masked_forward_backward_shift if name == "shift"
              else estep.masked_forward_backward)
        gamma, _, total = fb(obs, estep.stack_graphs([g], dev), n,
                             table.num_slots)
        gam = gamma[0].double().cpu().numpy()
        occ = gam.sum(1)
        print(f"{name}: log-likelihood {float(total[0]):.4f}, max |gamma - "
              f"gamma64| {np.abs(gam - gamma64).max():.4g}, occupancy a "
              f"frame {occ.min():.4f}..{occ.max():.4f}")
        stats[name] = {k: v[0] for k, v in fetch(estep.chain_stats(
            scorer, x, estep.stack_graphs([g], dev), n,
            table.num_slots)).items()}
    print("plain against shift, max |difference| / scale: " + ", ".join(
        f"{k} {np.abs(stats['plain'][k] - stats['shift'][k]).max() / max(np.abs(stats['shift'][k]).max(), 1e-30):.3g}"
        for k in ("gamma", "mean_acc", "sec_acc", "trans_acc")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
