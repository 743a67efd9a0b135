"""State-level segmentation of a decoded hypothesis.

Counterpart of `aaltoasr_tpu/decoder/stateseg.py`: `hypothesis_fst` is
host code; `state_segmentation` compiles the network on the host and
runs the masked Viterbi (`train/estep.py`) at B=1 on the observations'
device.

The reference decoder keeps a per-token ref-counted StateHistory chain
when `set_keep_state_segmentation(1)` is on and prints
``start_frame end_frame state_id`` lines per 1-best state run
(`decoder/src/Toolbox.hh:261-265,334`, `TokenPassSearch.cc:668-680`
print_state_history; consumed by `pyrectool/recognize-stateseg.py`).

Instead of threading a history chain through the batched search (a
per-frame [W]-sized record stack), the decoded word sequence is re-aligned with the already-existing hmmnet Viterbi — the
state path that maximizes the acoustic+transition score for the fixed
word sequence IS the in-search winner's state path (the LM contribution
is constant given the words), so one extra masked scan per utterance
reproduces the reference output without touching the search hot loop.
With a duration model active (duration_scale > 0) boundaries are the
duration-free optimum — the same convention as the reference's `align`
tool (`aku/Viterbi.cc` has no duration model either).

Multiple pronunciations per word re-align as alternative branches; the
Viterbi picks the acoustically best, matching the search's choice.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from aaltoasr_tpu_torch.models.hmmnet import (
    Fst, FstArc, _expand_phone, compile_hmmnet)


@dataclass
class StateSegment:
    start: int          # first frame (inclusive)
    end: int            # one past the last frame (exclusive)
    state: int          # tied emission state id (hmm_model in the ref)


def _resolve(phone_map, left, c, right):
    from aaltoasr_tpu_torch.decoder.lexicon import _resolve_context
    return _resolve_context(phone_map, left, c, right) or c


def hypothesis_fst(model, table, word_prons: list,
                   silence_prons: list | None = None,
                   optional_silence: str = "_",
                   context_phones: bool | None = None) -> Fst:
    """FST for a decoded word sequence: optional silence between words,
    alternative pronunciations as parallel branches.

    word_prons: per word, a list of alternative phone sequences.
    silence_prons: phone sequences the decoder may have crossed
    without emitting a word (silence lexicon entries, e.g. ['_'] and
    ['__']); defaults to [optional_silence] when modeled.
    context_phones: resolve tied-triphone labels with the actual
    cross-word neighbors (first pronunciation of each neighbor);
    auto-detected from the model's phone inventory by default.
    """
    phone_map = {p.label: p for p in model.phones}
    if context_phones is None:
        context_phones = any(("-" in l or "+" in l) for l in phone_map)
    if silence_prons is None:
        silence_prons = ([[optional_silence]]
                         if optional_silence in phone_map else [])
    silence_prons = [p for p in silence_prons
                     if all(ph in phone_map for ph in p)]
    fst = Fst()
    nxt = [0]

    def node():
        n = nxt[0]
        nxt[0] += 1
        fst.num_nodes = max(fst.num_nodes, n + 1)
        return n

    start = node()
    fst.initial = start

    def maybe_silence(at):
        if not silence_prons:
            return at
        out = node()
        fst.add_arc(FstArc(at, out))
        for pron in silence_prons:
            entry = node()
            fst.add_arc(FstArc(at, entry))
            p = entry
            for lbl in pron:
                p = _expand_phone(fst, model, table, lbl, p, node)
            fst.add_arc(FstArc(p, out))
        return out

    cur = maybe_silence(start)
    W = len(word_prons)
    for i, prons in enumerate(word_prons):
        prev_last = (word_prons[i - 1][0][-1] if i > 0
                     else optional_silence)
        next_first = (word_prons[i + 1][0][0] if i + 1 < W
                      else optional_silence)
        out = node()
        for pron in prons:
            labels = list(pron)
            if context_phones:
                n = len(pron)
                labels = [
                    _resolve(phone_map,
                             pron[j - 1] if j > 0 else prev_last,
                             pron[j],
                             pron[j + 1] if j + 1 < n else next_first)
                    for j in range(n)]
            entry = node()
            fst.add_arc(FstArc(cur, entry))
            at = entry
            for lbl in labels:
                at = _expand_phone(fst, model, table, lbl, at, node)
            fst.add_arc(FstArc(at, out))
        cur = maybe_silence(out)
    fst.final = cur
    return fst


def state_segmentation(model, table, obs, n_frames: int,
                       word_prons: list,
                       silence_prons: list | None = None,
                       optional_silence: str = "_",
                       device: torch.device | str | None = None) -> list:
    """Re-align a decoded hypothesis; returns [StateSegment].

    obs: [T, S] state log-likelihoods (the same array the decoder
    consumed), numpy or a tensor; the Viterbi runs on ``device`` (by
    default the tensor's own, the CPU for numpy).  word_prons: per
    decoded word, alternative phone sequences (from the lexicon).
    """
    from aaltoasr_tpu_torch.train import estep

    fst = hypothesis_fst(model, table, word_prons,
                         silence_prons=silence_prons,
                         optional_silence=optional_silence)
    graph, _ = compile_hmmnet(fst, table)
    obs = torch.as_tensor(obs, dtype=torch.float32, device=device)
    g = estep.stack_graphs([graph], obs.device)
    obs_pos = obs[:, g["pdf"][0]] + g["obs_const"]
    path, _ = estep.masked_viterbi(obs_pos[None], g, torch.tensor(
        [n_frames], device=obs.device))
    path = path[0].cpu().numpy()[:n_frames]
    states = graph["pdf"][path]
    inst = graph["inst"]
    segs: list = []
    prev_key = None
    for t, s in enumerate(states):
        # one segment per state occupancy: positions are emitting arcs
        # (a k-frame stay = k-1 self-loops + the exit arc, same source
        # state and phone instance), so runs key on (instance, state)
        key = (int(inst[path[t]]), int(s))
        if segs and key == prev_key:
            segs[-1].end = t + 1
        else:
            segs.append(StateSegment(start=t, end=t + 1, state=int(s)))
            prev_key = key
    return segs


def write_state_segmentation(path: str, segs: list) -> None:
    """``start end state`` lines (Toolbox::write_state_segmentation,
    TokenPassSearch.cc:668-680)."""
    with open(path, "w") as f:
        for s in segs:
            f.write(f"{s.start} {s.end} {s.state}\n")
