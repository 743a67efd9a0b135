"""Decision-tree state tying of context phones (`aku/PhonePool.{hh,cc}`,
`aku/tie.cc`).

Context phones ("l-c+r" labels, optionally wider l2-l1-c+r1+r2) accumulate
full-covariance statistics per (center phone, state).  Top-down greedy
splitting by phoneme-set rules ("RULE context ph1,ph2,..."):

* candidate = (rule, context index != 0, answer); both children must keep
  ``min_occupancy`` and the split must gain at least ``min_split_gain``
  of log-likelihood, gain = (N_p ln|S_p| - N_1 ln|S_1| - N_2 ln|S_2|)/2
  (PhonePool.cc:904-917, 535-625);
* optional bottom-up re-merging of leaves with loss < ``max_merge_loss``
  (PhonePool.cc:830-890).

Output: an initial tied-state model (one Gaussian per tied state,
transitions 0.8 self / 0.2 forward, PhonePool.cc:965-966) or a basebind
file.  The per-frame statistics accumulation uses the device scorer's
feature pipeline; the tree search itself is host NumPy (tiny and
sequential by nature — SURVEY §7 hard part (f)).

Host copy of `aaltoasr_tpu/train/tie.py`.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field

import numpy as np

from aaltoasr_tpu_torch.formats.model_io import HmmModel, HmmPhone


def center_phone(label: str) -> str:
    """Center phone of a context label (PhonePool.cc:339-362)."""
    pos1 = label.rfind("-")
    pos2 = label.find("+")
    if pos1 >= 0 and pos2 >= 0:
        if pos2 > pos1 + 1:
            return label[pos1 + 1:pos2]
        raise ValueError(f"PhonePool: Invalid phone label {label}")
    if pos1 >= 0:
        return label[pos1 + 1:]
    if pos2 >= 0:
        return label[:pos2]
    return label


def left_contexts(label: str) -> list:
    """Left context phones, nearest first (context index -1, -2, ...)."""
    pos = label.rfind("-")
    if pos < 0:
        return []
    return label[:pos].split("-")[::-1]


def right_contexts(label: str) -> list:
    pos = label.find("+")
    if pos < 0:
        return []
    return label[pos + 1:].split("+")


@dataclass
class ContextPhoneStats:
    label: str
    occupancy: float = 0.0
    m1: np.ndarray | None = None    # sum gamma x
    m2: np.ndarray | None = None    # sum gamma x x^T

    def add(self, gamma, x):
        x = np.asarray(x, dtype=np.float64)
        if self.m1 is None:
            self.m1 = np.zeros(x.shape[-1])
            self.m2 = np.zeros((x.shape[-1], x.shape[-1]))
        if x.ndim == 1:
            self.occupancy += gamma
            self.m1 += gamma * x
            self.m2 += gamma * np.outer(x, x)
        else:
            g = np.asarray(gamma, dtype=np.float64)
            self.occupancy += float(g.sum())
            self.m1 += g @ x
            self.m2 += (x * g[:, None]).T @ x

    def context(self, index: int) -> str | None:
        """Context phone at signed index (-1 = nearest left, +1 = nearest
        right), or None if absent."""
        ctx = left_contexts(self.label) if index < 0 \
            else right_contexts(self.label)
        i = abs(index) - 1
        return ctx[i] if i < len(ctx) else None


def _cluster_logdet(occ, m1, m2, dim):
    if occ <= 0:
        return 0.0
    mean = m1 / occ
    cov = m2 / occ - np.outer(mean, mean)
    cov = cov + 1e-8 * np.eye(dim)
    sign, logdet = np.linalg.slogdet(cov)
    if sign <= 0:
        return -1e10
    return logdet


@dataclass
class Cluster:
    members: list                    # ContextPhoneStats refs
    rules: list = field(default_factory=list)  # (rule_name, ctx, answer)
    # routing chains for UNSEEN context phones: each chain is one
    # (phone_set, ctx, answer) list; a label belongs to the cluster
    # when any chain is fully satisfied (merged clusters carry the
    # chains of all their sources — PhonePool.cc:1091-1125
    # iterate_context_phones / num_applied_rule_sets)
    rule_sets: list = field(default_factory=list)

    def routes(self, label: str) -> bool:
        for chain in self.rule_sets:
            ok = True
            for phone_set, ctx, answer in chain:
                ctxs = (left_contexts(label) if ctx < 0
                        else right_contexts(label))
                i = abs(ctx) - 1
                got = (ctxs[i] in phone_set) if i < len(ctxs) else False
                if got != answer:
                    ok = False
                    break
            if ok:
                return True
        return False

    def stats(self):
        occ = sum(m.occupancy for m in self.members)
        m1 = sum((m.m1 for m in self.members if m.m1 is not None),
                 start=0.0)
        m2 = sum((m.m2 for m in self.members if m.m2 is not None),
                 start=0.0)
        return occ, m1, m2


class PhonePool:
    """Context-phone statistics pool + decision-tree tying."""

    def __init__(self, dim: int, info: int = 0):
        self.dim = dim
        self.info = info
        self.rules: list = []        # (name, frozenset of phones)
        # (center, state) -> {label: ContextPhoneStats}
        self.phones: dict = {}
        self.min_occupancy = 100.0
        self.min_split_gain = 0.0
        self.max_merge_loss = None

    # -- rules ------------------------------------------------------------
    def load_rules(self, path_or_text) -> None:
        """Rule file: ``NAME context ph1,ph2,...`` per line
        (PhonePool.cc:401-435)."""
        text = path_or_text
        if "\n" not in str(text):
            with open(text) as f:
                text = f.read()
        for line in text.splitlines():
            fields = line.split(None, 2)
            if not fields:
                continue
            if len(fields) < 2:
                raise ValueError(f"Invalid rule line: {line}")
            if fields[1].lower() != "context":
                raise ValueError(f"Invalid rule type {fields[1]}")
            phones = [p for p in fields[2].replace(",", " ").split()]
            if not phones:
                raise ValueError(f"No phones in the context rule: {line}")
            self.rules.append((fields[0], frozenset(phones)))

    # -- statistics -------------------------------------------------------
    def get_context_phone(self, label: str, state: int) -> ContextPhoneStats:
        center = center_phone(label)
        key = (center, state)
        bucket = self.phones.setdefault(key, {})
        if label not in bucket:
            bucket[label] = ContextPhoneStats(label)
            # the pool-level context set drives the basebind cross
            # product (PhonePool.cc:34-40 add_context)
            if not hasattr(self, "contexts"):
                self.contexts = set()
            self.contexts.update(left_contexts(label))
            self.contexts.update(right_contexts(label))
        return bucket[label]

    # -- tying ------------------------------------------------------------
    def _gain(self, parent: Cluster, part1: list, part2: list) -> float:
        po, pm1, pm2 = parent.stats()
        c1 = Cluster(part1)
        c2 = Cluster(part2)
        o1, m11, m21 = c1.stats()
        o2, m12, m22 = c2.stats()
        return (po * _cluster_logdet(po, pm1, pm2, self.dim)
                - o1 * _cluster_logdet(o1, m11, m21, self.dim)
                - o2 * _cluster_logdet(o2, m12, m22, self.dim)) / 2.0

    def _best_split(self, cl: Cluster, context_range):
        best = None
        applied_sets = []
        for (name, phone_set) in self.rules:
            for ctx in context_range:
                if ctx == 0:
                    continue
                yes = [m for m in cl.members
                       if (m.context(ctx) or "") in phone_set]
                no = [m for m in cl.members if m not in yes]
                o1 = sum(m.occupancy for m in yes)
                o2 = sum(m.occupancy for m in no)
                if o1 < self.min_occupancy or o2 < self.min_occupancy:
                    continue
                # canonical smaller set for dedup (PhonePool.cc:568-585)
                first = yes if len(yes) <= len(cl.members) // 2 else no
                key = frozenset(m.label for m in first)
                if key in applied_sets:
                    continue
                applied_sets.append(key)
                answer = first is yes
                part1, part2 = (yes, no) if answer else (no, yes)
                gain = self._gain(cl, part1, part2)
                if gain > self.min_split_gain and (
                        best is None or gain > best[0]):
                    best = (gain, name, ctx, answer, part1, part2,
                            phone_set)
        return best

    def tie(self, max_context_index: int = 0) -> dict:
        """Run tying; returns {(center, state): [Cluster, ...]}."""
        result = {}
        total = 0
        for (center, state), bucket in sorted(self.phones.items()):
            members = list(bucket.values())
            maxl = max((len(left_contexts(m.label)) for m in members),
                       default=0)
            maxr = max((len(right_contexts(m.label)) for m in members),
                       default=0)
            if max_context_index > 0:
                maxl = min(maxl, max_context_index)
                maxr = min(maxr, max_context_index)
            ctx_range = list(range(-maxl, maxr + 1))
            clusters = [Cluster(members)]
            i = 0
            while i < len(clusters):
                best = self._best_split(clusters[i], ctx_range)
                if best is not None:
                    (gain, name, ctx, answer, part1, part2,
                     phone_set) = best
                    rules = list(clusters[i].rules)
                    chain = (clusters[i].rule_sets[0]
                             if clusters[i].rule_sets else [])
                    clusters[i] = Cluster(
                        part1, rules + [(name, ctx, answer)],
                        [chain + [(phone_set, ctx, answer)]])
                    clusters.append(Cluster(
                        part2, rules + [(name, ctx, not answer)],
                        [chain + [(phone_set, ctx, not answer)]]))
                    # reconsider the split cluster (PhonePool.cc:517)
                else:
                    i += 1
            result[(center, state)] = clusters
            total += len(clusters)
            if self.info > 0:
                import sys
                print(f"Phone {center} state {state}: "
                      f"{len(clusters)} clusters", file=sys.stderr)
        if self.info > 0:
            import sys
            print(f"Total: {total} clusters generated", file=sys.stderr)
        self.result = result
        return result

    def merge(self, max_merge_loss: float) -> int:
        """Post-clustering merge pass (PhonePool.cc:844-900
        merge_context_phones): within each (phone, state), repeatedly
        absorb the partner whose merge costs the least log-likelihood,
        while that cost stays under ``max_merge_loss``.  Returns the
        number of merges performed."""
        merged_total = 0
        for key, clusters in self.result.items():
            c = 0
            while c < len(clusters):
                min_loss = 2 * max_merge_loss
                best = -1
                for i in range(c + 1, len(clusters)):
                    loss = self._gain(
                        Cluster(clusters[c].members
                                + clusters[i].members),
                        clusters[c].members, clusters[i].members)
                    if loss < min_loss:
                        min_loss = loss
                        best = i
                if best >= 0 and min_loss < max_merge_loss:
                    clusters[c] = Cluster(
                        clusters[c].members + clusters[best].members,
                        clusters[c].rules,
                        clusters[c].rule_sets + clusters[best].rule_sets)
                    del clusters[best]
                    merged_total += 1
                    # reprocess the grown cluster (PhonePool.cc:884 c--)
                else:
                    c += 1
            if self.info > 0:
                import sys
                print(f"Phone {key[0]} state {key[1]}: "
                      f"{len(clusters)} clusters after merging",
                      file=sys.stderr)
        return merged_total

    # -- outputs ----------------------------------------------------------
    def make_model(self, diagonal: bool = True) -> HmmModel:
        """Initial tied model: one Gaussian per tied state, transitions
        0.8 self / 0.2 forward (PhonePool.cc:933-1000)."""
        means, covars, mixtures = [], [], []
        transitions = {}
        state_of_cluster = {}
        idx = 0
        centers = {}
        for (center, state), clusters in sorted(self.result.items()):
            for c, cl in enumerate(clusters):
                occ, m1, m2 = cl.stats()
                mean = m1 / occ if occ > 0 else np.zeros(self.dim)
                cov = (m2 / occ - np.outer(mean, mean)) if occ > 0 \
                    else np.eye(self.dim)
                means.append(mean)
                covars.append(np.maximum(np.diag(cov), 1e-3))
                mixtures.append((np.array([idx], dtype=np.int32),
                                 np.array([1.0])))
                transitions[idx] = [(0, 0.8), (1, 0.2)]
                state_of_cluster[(center, state, c)] = idx
                idx += 1
            centers.setdefault(center, 0)
            centers[center] = max(centers[center], state + 1)

        # per context phone label: pick its cluster chain per state
        phones = []
        labels = {}
        for (center, state), clusters in sorted(self.result.items()):
            for c, cl in enumerate(clusters):
                for m in cl.members:
                    labels.setdefault(m.label, {})[state] = \
                        state_of_cluster[(center, state, c)]
        for label in sorted(labels):
            sts = labels[label]
            phones.append(HmmPhone(
                label=label,
                states=[sts[s] for s in sorted(sts)]))

        return HmmModel(
            dim=self.dim, cov_type="diagonal_cov",
            means=np.asarray(means), covars=np.asarray(covars),
            mixtures=mixtures, phones=phones, transitions=transitions)

    def save_basebind(self, path, initial_state_index: int = 0,
                      max_context_index: int = 0) -> None:
        """LABEL NUM_STATES IDX... lines (fileformats.html Basebind).

        With ``max_context_index`` > 0 this reproduces the reference
        enumeration exactly (`PhonePool::save_to_basebind` +
        `iterate_context_phones`, PhonePool.cc:1021-1152): state
        indices are allocated per (center phone, state, cluster) in
        sorted center order; every non-silence center phone emits one
        line per context CROSS PRODUCT over the pool's observed
        context set (rightmost context varying fastest), each state
        routed to its cluster through the applied decision-rule
        chains; silence phones ('_'-initial) emit their bare label.
        With 0, only observed labels are written (the compact form our
        segfea consumes)."""
        idx_map = {}
        idx = initial_state_index
        for (center, state), clusters in sorted(self.result.items()):
            for c, cl in enumerate(clusters):
                idx_map[(center, state, c)] = idx
                idx += 1
        if max_context_index <= 0:
            labels = {}
            for (center, state), clusters in sorted(self.result.items()):
                for c, cl in enumerate(clusters):
                    for m in cl.members:
                        labels.setdefault(m.label, {})[state] = \
                            idx_map[(center, state, c)]
            with open(path, "w") as f:
                for label in sorted(labels):
                    sts = labels[label]
                    ids = " ".join(str(sts[s]) for s in sorted(sts))
                    f.write(f"{label} {len(sts)} {ids}\n")
            return
        centers = sorted({c for (c, s) in self.result})
        n_states = {c: 1 + max(s for (c2, s) in self.result if c2 == c)
                    for c in centers}
        ctxs = sorted(getattr(self, "contexts", set()))
        M = max_context_index
        with open(path, "w") as f:
            for center in centers:
                if center.startswith("_"):
                    ids = [idx_map[(center, s, 0)]
                           for s in range(n_states[center])]
                    f.write(f"{center} {len(ids)} "
                            f"{' '.join(map(str, ids))}\n")
                    continue
                # odometer over 2M context slots, rightmost fastest
                for combo in itertools.product(ctxs, repeat=2 * M):
                    label = ("-".join(combo[:M]) + "-" + center + "+"
                             + "+".join(combo[M:]))
                    ids = []
                    for s in range(n_states[center]):
                        clusters = self.result[(center, s)]
                        ci = 0
                        if len(clusters) > 1:
                            ci = -1
                            for i, cl in enumerate(clusters):
                                if cl.routes(label):
                                    ci = i
                                    break
                            assert ci >= 0, label
                        ids.append(idx_map[(center, s, ci)])
                    f.write(f"{label} {len(ids)} "
                            f"{' '.join(map(str, ids))}\n")
