""".gcl Gaussian clustering files (`aku/gcluster.cc`).

Host copy of the two I/O functions of `aaltoasr_tpu/train/gcluster.py`.
First line: the cluster count; then ``gauss_index cluster_index`` pairs
(`aku/Distributions.cc:3114-3147` read_clustering), used by
`phone_probs -C` to evaluate only the Gaussians of the top-scoring
clusters.
"""

from __future__ import annotations

import numpy as np


def write_gcl(path, assign: np.ndarray, num_clusters: int) -> None:
    with open(path, "w") as f:
        f.write(f"{num_clusters}\n")
        for g, c in enumerate(assign):
            f.write(f"{g} {int(c)}\n")


def read_gcl(path) -> tuple[np.ndarray, int]:
    with open(path) as f:
        tokens = f.read().split()
    num_clusters = int(tokens[0])
    pairs = np.asarray(tokens[1:], dtype=np.int64).reshape(-1, 2)
    G = int(pairs[:, 0].max()) + 1 if len(pairs) else 0
    assign = np.zeros(G, dtype=np.int32)
    assign[pairs[:, 0]] = pairs[:, 1]
    return assign, num_clusters
