"""HMM topology compiled to SoA arrays: transitions, chains, fan-in graphs.

Host copy of `aaltoasr_tpu/models/hmm.py`.

The reference threads HMM topology through pointer-rich C++ objects
(`aku/HmmSet.hh:22-81`: Hmm/HmmState/HmmTransition with relative target
offsets).  For the device scans everything becomes flat arrays:

* `TransitionTable` — the model's tied-state transitions flattened into
  parallel arrays with stable slot numbering (state-major, file order),
  matching the reference's sequential transition indexing
  (`aku/HmmSet.cc:318-340` add_transition ordering) so .phs statistics
  dumps line up 1:1.
* `LinearChain` — a transcription expanded into a left-to-right position
  graph (the E-step/alignment "numerator" graph): per-position pdf ids,
  and an edge list (src, tgt, logprob, slot) that Viterbi/forward-backward
  scans consume.  Equivalent of the implicit (frame x transcription
  position) lattice of `aku/Viterbi.{hh,cc}`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from aaltoasr_tpu_torch.formats.model_io import HmmModel
from aaltoasr_tpu_torch.formats.phn import PhnEntry
from aaltoasr_tpu_torch.ops.logsemiring import LOG_ZERO


@dataclass(frozen=True)
class TransitionTable:
    """Flattened tied-state transitions with stable slot ids."""

    source: np.ndarray        # [NT] tied-state index per slot
    offset: np.ndarray        # [NT] relative target offset
    prob: np.ndarray          # [NT] probability
    state_first: np.ndarray   # [S] first slot of each state
    state_count: np.ndarray   # [S] slots per state

    @classmethod
    def from_model(cls, model: HmmModel) -> "TransitionTable":
        S = model.num_states
        source, offset, prob = [], [], []
        first = np.zeros(S, dtype=np.int32)
        count = np.zeros(S, dtype=np.int32)
        for s in range(S):
            first[s] = len(source)
            for off, p in model.transitions.get(s, []):
                source.append(s)
                offset.append(off)
                prob.append(p)
            count[s] = len(source) - first[s]
        return cls(
            source=np.asarray(source, dtype=np.int32),
            offset=np.asarray(offset, dtype=np.int32),
            prob=np.asarray(prob, dtype=np.float64),
            state_first=first, state_count=count)

    @property
    def num_slots(self) -> int:
        return len(self.source)

    def log_probs(self) -> np.ndarray:
        with np.errstate(divide="ignore"):
            return np.where(self.prob > 0, np.log(self.prob), LOG_ZERO)


@dataclass
class LinearChain:
    """A transcription as a position graph for one utterance.

    positions: pdf[p] (tied state), phone_index[p], state_in_phone[p],
    label per phone.  Edges cover self-loops, in-phone skips, and
    phone-exit -> next-phone-entry transitions; `slot` ties each edge to
    its TransitionTable slot for transition statistics.
    """

    pdf: np.ndarray            # [P] tied-state id per position
    phone_index: np.ndarray    # [P] transcript index
    state_in_phone: np.ndarray  # [P]
    labels: list               # per transcript entry
    edge_src: np.ndarray       # [E]
    edge_tgt: np.ndarray       # [E]
    edge_logp: np.ndarray      # [E] float32
    edge_slot: np.ndarray      # [E] TransitionTable slot (or -1)
    final_logp: float          # exit-transition log-prob of last position
    final_slot: int = 0        # TransitionTable slot of that exit

    @property
    def num_positions(self) -> int:
        return len(self.pdf)

    @property
    def num_edges(self) -> int:
        return len(self.edge_src)


def build_chain(model: HmmModel, table: TransitionTable,
                labels: list) -> LinearChain:
    """Expand a phone-label sequence into a LinearChain.

    Within a phone of k states, a transition slot with offset ``o`` from
    state i targets position i+o; ``i+o == k`` is the phone exit, wired to
    the next phone's first position (`aku/HmmSet.cc:258-271` offset
    semantics).  The final phone's exit weight is returned separately and
    applied after the last frame.
    """
    pdf, phone_index, state_in_phone = [], [], []
    phone_start = []
    for pi, label in enumerate(labels):
        phone = model.phone(label)
        phone_start.append(len(pdf))
        for i, s in enumerate(phone.states):
            pdf.append(s)
            phone_index.append(pi)
            state_in_phone.append(i)
    P = len(pdf)
    if P == 0:
        raise ValueError("empty transcription")
    phone_start.append(P)  # sentinel

    log_probs = table.log_probs()
    edge_src, edge_tgt, edge_logp, edge_slot = [], [], [], []
    final_logp = 0.0
    final_slot = 0
    for p in range(P):
        s = pdf[p]
        pi = phone_index[p]
        i = state_in_phone[p]
        k = phone_start[pi + 1] - phone_start[pi]
        for slot in range(table.state_first[s],
                          table.state_first[s] + table.state_count[s]):
            o = int(table.offset[slot])
            lp = float(log_probs[slot])
            if i + o < k:
                tgt = phone_start[pi] + i + o
            elif i + o == k:
                if pi + 1 < len(labels):
                    tgt = phone_start[pi + 1]
                else:
                    final_logp = lp
                    final_slot = slot
                    continue
            else:
                continue  # skip beyond phone end (invalid)
            edge_src.append(p)
            edge_tgt.append(tgt)
            edge_logp.append(lp)
            edge_slot.append(slot)

    return LinearChain(
        pdf=np.asarray(pdf, dtype=np.int32),
        phone_index=np.asarray(phone_index, dtype=np.int32),
        state_in_phone=np.asarray(state_in_phone, dtype=np.int32),
        labels=list(labels),
        edge_src=np.asarray(edge_src, dtype=np.int32),
        edge_tgt=np.asarray(edge_tgt, dtype=np.int32),
        edge_logp=np.asarray(edge_logp, dtype=np.float32),
        edge_slot=np.asarray(edge_slot, dtype=np.int32),
        final_logp=final_logp, final_slot=final_slot)


def chain_from_phn(model: HmmModel, table: TransitionTable,
                   entries: list) -> LinearChain:
    """Chain from .phn transcript entries (phone labels, times ignored)."""
    return build_chain(model, table, [e.label for e in entries])


def pad_chain(chain: LinearChain, pad_positions: int, fan: int = 0):
    """Compile a chain to dense padded fan-in/fan-out tables for the scans.

    Returns a dict of fixed-shape arrays:

    * ``in_src/in_logp/in_slot``  [P, F] — incoming edges per position
      (padded with self-reference at LOG_ZERO weight, slot 0)
    * ``out_tgt/out_logp``        [P, F] — outgoing edges per position
    * ``pdf``                     [P]    — tied-state id (0 on padding)
    * ``num_positions``, ``final_logp`` scalars

    A dense [P, F] layout (F = max fan-in, typically 2-3 for left-to-right
    HMMs) turns the lattice reduction into gather + small-axis reductions —
    no scatter in the inner scan.
    """
    P, E = chain.num_positions, chain.num_edges
    if P > pad_positions:
        raise ValueError("chain exceeds padding")
    fan_in = np.zeros(P, dtype=np.int64)
    fan_out = np.zeros(P, dtype=np.int64)
    for e in range(E):
        fan_in[chain.edge_tgt[e]] += 1
        fan_out[chain.edge_src[e]] += 1
    F = max(fan, int(fan_in.max(initial=1)), int(fan_out.max(initial=1)))

    Pp = pad_positions
    in_src = np.zeros((Pp, F), dtype=np.int32)
    in_logp = np.full((Pp, F), LOG_ZERO, dtype=np.float32)
    in_slot = np.zeros((Pp, F), dtype=np.int32)
    out_tgt = np.zeros((Pp, F), dtype=np.int32)
    out_logp = np.full((Pp, F), LOG_ZERO, dtype=np.float32)
    # padding rows point at themselves so gathers stay in bounds
    in_src[:] = np.arange(Pp, dtype=np.int32)[:, None]
    out_tgt[:] = np.arange(Pp, dtype=np.int32)[:, None]

    ni = np.zeros(Pp, dtype=np.int64)
    no = np.zeros(Pp, dtype=np.int64)
    for e in range(E):
        s, t = int(chain.edge_src[e]), int(chain.edge_tgt[e])
        in_src[t, ni[t]] = s
        in_logp[t, ni[t]] = chain.edge_logp[e]
        in_slot[t, ni[t]] = chain.edge_slot[e]
        ni[t] += 1
        out_tgt[s, no[s]] = t
        out_logp[s, no[s]] = chain.edge_logp[e]
        no[s] += 1

    pdf = np.zeros(Pp, dtype=np.int32)
    pdf[:P] = chain.pdf
    inst = np.zeros(Pp, dtype=np.int32)
    inst[:P] = chain.phone_index
    return {
        "pdf": pdf,
        "in_src": in_src, "in_logp": in_logp, "in_slot": in_slot,
        "out_tgt": out_tgt, "out_logp": out_logp,
        "num_positions": np.int32(P),
        "final_logp": np.float32(chain.final_logp),
        "final_slot": np.int32(chain.final_slot),
        "inst": inst,
        # state-synchronous chain graphs have no arc-level parent-arc
        # grouping (the reference's -M only applies to hmmnets, stats.cc
        # -H path); singleton groups make mpv degenerate to plain BW
        "mpv_gid": np.arange(Pp, dtype=np.int32),
    }
