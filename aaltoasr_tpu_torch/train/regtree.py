"""Regression class tree over Gaussians for adaptation
(`aku/RegClassTree.{hh,cc}`).

The reference splits units (Gaussians/mixtures/phones) top-down, seeding
two children by perturbing the unit-weighted mean along its principal
component, then iterating 2-means to convergence (RegClassTree.hh:8-36).
Same algorithm here over Gaussian means with occupancy weights; terminal
nodes become the regression classes written to / read from the tree file.

Host copy of `aaltoasr_tpu/train/regtree.py`: the same means give the
same classes and the same tree file.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class RegNode:
    index: int                       # 1-based like the reference tree files
    gaussians: np.ndarray            # member Gaussian ids
    children: list = field(default_factory=list)

    @property
    def terminal(self) -> bool:
        return not self.children


def _split_2means(means, weights, rng, iters: int = 10):
    """PCA-perturbed 2-means split; returns boolean membership of child 1."""
    w = weights / max(weights.sum(), 1e-10)
    mu = w @ means
    centered = means - mu
    cov = (centered * w[:, None]).T @ centered
    vals, vecs = np.linalg.eigh(cov)
    pc = vecs[:, -1] * np.sqrt(max(vals[-1], 1e-10))
    c1, c2 = mu + pc, mu - pc
    assign = None
    for _ in range(iters):
        d1 = np.sum((means - c1) ** 2, axis=1)
        d2 = np.sum((means - c2) ** 2, axis=1)
        new_assign = d1 <= d2
        if assign is not None and np.array_equal(new_assign, assign):
            break
        assign = new_assign
        for side, c in ((assign, 1), (~assign, 2)):
            if side.any():
                ww = weights[side] / max(weights[side].sum(), 1e-10)
                if c == 1:
                    c1 = ww @ means[side]
                else:
                    c2 = ww @ means[side]
    return assign


def build_regression_tree(means: np.ndarray,
                          occupancies: np.ndarray | None = None,
                          num_terminals: int = 2,
                          min_gaussians: int = 8,
                          seed: int = 0) -> RegNode:
    """Binary regression tree until ``num_terminals`` leaves."""
    G = means.shape[0]
    if occupancies is None:
        occupancies = np.ones(G)
    rng = np.random.default_rng(seed)
    root = RegNode(1, np.arange(G))
    leaves = [root]
    next_index = 2
    while len(leaves) < num_terminals:
        # split the heaviest splittable leaf
        leaves.sort(key=lambda n: -occupancies[n.gaussians].sum())
        for leaf in leaves:
            if len(leaf.gaussians) >= 2 * min_gaussians:
                break
        else:
            break
        g = leaf.gaussians
        assign = _split_2means(means[g], occupancies[g], rng)
        if assign is None or not assign.any() or assign.all():
            break
        c1 = RegNode(next_index, g[assign])
        c2 = RegNode(next_index + 1, g[~assign])
        next_index += 2
        leaf.children = [c1, c2]
        leaves.remove(leaf)
        leaves.extend([c1, c2])
    return root


def terminal_classes(root: RegNode, num_gaussians: int) -> np.ndarray:
    """[G] class index (0-based, dense) per Gaussian."""
    classes = np.zeros(num_gaussians, dtype=np.int32)
    idx = 0

    def walk(node):
        nonlocal idx
        if node.terminal:
            classes[node.gaussians] = idx
            idx += 1
        else:
            for c in node.children:
                walk(c)

    walk(root)
    return classes


def write_regtree(root: RegNode, path) -> None:
    """Tree file: one line per node: index terminal(0/1) [children|gauss]."""
    with open(path, "w") as f:
        def walk(node):
            if node.terminal:
                ids = " ".join(str(int(g)) for g in node.gaussians)
                f.write(f"{node.index} 1 {ids}\n")
            else:
                kids = " ".join(str(c.index) for c in node.children)
                f.write(f"{node.index} 0 {kids}\n")
                for c in node.children:
                    walk(c)
        walk(root)


def read_regtree(path, num_gaussians: int) -> np.ndarray:
    """Read a tree file back -> [G] dense class assignment."""
    terminals = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2 and parts[1] == "1":
                terminals.append([int(x) for x in parts[2:]])
    classes = np.zeros(num_gaussians, dtype=np.int32)
    for i, gs in enumerate(terminals):
        classes[gs] = i
    return classes
