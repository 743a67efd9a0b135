"""Gaussian clustering for gated evaluation (`aku/gcluster.cc`).

Produces the .gcl clustering file (first line: cluster count; then
``gauss_index cluster_index`` pairs, `aku/Distributions.cc:3114-3147`
read_clustering) used to evaluate only the Gaussians of the top-scoring
clusters (`decode-stream.cc:113-117`, eval-ming).

Host copy of `aaltoasr_tpu/train/gcluster.py`.

The reference clusters agglomeratively with KL criteria; here a weighted
k-means over pool means (occupancy-weighted, KL-insensitive init) gives
the same artifact at a fraction of the cost — the clustering only
gates work, it does not change results.
"""

from __future__ import annotations

import numpy as np


def cluster_gaussians(means: np.ndarray, num_clusters: int,
                      weights: np.ndarray | None = None,
                      iters: int = 25, seed: int = 0) -> np.ndarray:
    """[G] cluster assignment via weighted k-means++-style clustering."""
    G = means.shape[0]
    C = min(num_clusters, G)
    rng = np.random.default_rng(seed)
    w = np.ones(G) if weights is None else np.maximum(weights, 1e-8)

    # k-means++ init
    centers = [means[rng.integers(G)]]
    d2 = np.sum((means - centers[0]) ** 2, axis=1)
    for _ in range(1, C):
        p = d2 * w
        p = p / p.sum() if p.sum() > 0 else np.full(G, 1.0 / G)
        centers.append(means[rng.choice(G, p=p)])
        d2 = np.minimum(d2, np.sum((means - centers[-1]) ** 2, axis=1))
    centers = np.stack(centers)

    assign = np.zeros(G, dtype=np.int32)
    for _ in range(iters):
        d = ((means[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        new_assign = np.argmin(d, axis=1).astype(np.int32)
        if np.array_equal(new_assign, assign):
            break
        assign = new_assign
        for c in range(C):
            m = assign == c
            if m.any():
                ww = w[m] / w[m].sum()
                centers[c] = ww @ means[m]
    return assign


def glibc_rand(seed: int = 1):
    """glibc TYPE_3 ``rand()`` sequence (gcluster.cc calls rand()
    without srand, i.e. seed 1): additive-feedback generator over a
    34-word state, first 310 outputs discarded, output = word >> 1."""
    r = [0] * 34
    r[0] = seed
    for i in range(1, 31):
        r[i] = (16807 * r[i - 1]) % 2147483647
    for i in range(31, 34):
        r[i] = r[i - 31]
    hist = list(r)
    out_index = 0
    for i in range(34, 10 ** 18):  # effectively unbounded
        val = (hist[i - 3] + hist[i - 31]) % (1 << 32)
        hist.append(val)
        out_index += 1
        if out_index > 310:
            yield val >> 1


def reference_permutation(num: int, rand=None) -> list[int]:
    """fill_random_permutation (gcluster.cc:167-179) with glibc rand."""
    if rand is None:
        rand = glibc_rand()
    p = list(range(num))
    for i in range(num):
        pos = i + next(rand) % (num - i)
        p[i], p[pos] = p[pos], p[i]
    return p


def cluster_gaussians_ref(means: np.ndarray, covs: np.ndarray,
                          num_clusters: int,
                          iterations: int = 4) -> np.ndarray:
    """Reference-exact diagonal clustering (gcluster.cc:132-291).

    Initial centers = the first ``num_clusters`` entries of the glibc
    random permutation of Gaussians; initial assignment by Euclidean
    mean distance; then ``iterations`` rounds of KL-divergence k-means
    where a cluster is the per-dimension average of its members' means
    and covariances and
    KL(g, c) = (ldet_c - ldet_g + sum((cov_g + dmean^2)/cov_c) - dim)/2.
    """
    means = np.asarray(means, dtype=np.float64)
    covs = np.asarray(covs, dtype=np.float64)
    G, D = means.shape
    C = num_clusters
    perm = reference_permutation(G)
    centers = means[perm[:C]]  # only means used for the Euclidean init

    d = np.sqrt(((means[:, None, :] - centers[None, :, :]) ** 2).sum(-1))
    assign = np.argmin(d, axis=1).astype(np.int64)

    ldet_g = np.log(covs).sum(-1)

    def stats(assign):
        cm = np.zeros((C, D))
        cc = np.zeros((C, D))
        cnt = np.bincount(assign, minlength=C).astype(np.float64)
        np.add.at(cm, assign, means)
        np.add.at(cc, assign, covs)
        valid = cnt > 0
        cm[valid] /= cnt[valid, None]
        cc[valid] /= cnt[valid, None]
        ldet = np.where(valid, np.log(np.where(cc > 0, cc, 1.0)).sum(-1),
                        0.0)
        return cm, cc, ldet, valid

    cm, cc, ldet_c, valid = stats(assign)
    for _ in range(iterations):
        diff = means[:, None, :] - cm[None, :, :]
        dist = (ldet_c[None, :] - ldet_g[:, None]
                + ((covs[:, None, :] + diff ** 2) / cc[None, :, :]).sum(-1)
                - D) / 2.0
        dist = np.where(valid[None, :], dist, 1e100)
        assign = np.argmin(dist, axis=1).astype(np.int64)
        cm, cc, ldet_c, valid = stats(assign)
    # compact to the reference's save numbering: valid clusters get
    # consecutive ids in cluster order (gcluster.cc:313-323)
    remap = -np.ones(C, dtype=np.int64)
    remap[valid] = np.arange(int(valid.sum()))
    return remap[assign]


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
