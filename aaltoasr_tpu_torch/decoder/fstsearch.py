"""FstSearch: Viterbi decoding over a precomposed WFST.

Counterpart of `aaltoasr_tpu/decoder/fstsearch.py` (reference:
`decoder/src/FstSearch.{hh,_tmpl.hh}` + `Fst.{hh,cc}` — a beam decoder
over a precomposed H(C)LG network whose arc input labels are transition
indices and output labels are words, `FstSearch.hh:4-14`, fed by LNA
acoustics).

The FST compiles through the training hmmnets' arc-synchronous machinery
(`models/hmmnet.compile_hmmnet`, host) into device tensors, and decodes
with the dense masked Viterbi (`train/estep.masked_viterbi`): no beams,
a frame loop with no host sync, the best path fetched once per decode;
the path's arc sequence yields the output words on the host.  The
confidence classes' hashed Viterbi is a frame loop on the device too:
each position carries a rolling word-sequence hash ``h * 31 + wid``
kept in int32 with two's-complement wrap, as the reference's XLA scan
computes it (an int64 hash would never wrap and would give other values,
and other collisions, on long paths).

Weight base: transition scores come from the acoustic model's transition
table (natural log), the convention of the training pipeline whose
hmmnet FSTs this shares.  FSTs written by the reference's `hmm2fsm`
embed log10 transition weights in the arc score field
(`decoder/src/hmm2fsm.cc:70`); `MitFstSearch` reads that convention.
Entry points run on ``device`` (default ``cuda``; with no GPU they raise
unless ``device="cpu"`` is given).
"""

from __future__ import annotations

import math
import zlib

import numpy as np
import torch

from aaltoasr_tpu_torch.device import resolve_device
from aaltoasr_tpu_torch.formats.fst import Fst, read_fst
from aaltoasr_tpu_torch.formats.lna import read_lna
from aaltoasr_tpu_torch.models.hmm import TransitionTable
from aaltoasr_tpu_torch.models.hmmnet import compile_hmmnet
from aaltoasr_tpu_torch.ops.logsemiring import LOG_ZERO
from aaltoasr_tpu_torch.train import estep


def _word_id(word: str) -> int:
    """The hash's per-word term (0 = no output label)."""
    return zlib.crc32(word.encode()) % 1000003 + 1 if word else 0


def _hash_push(h: torch.Tensor, wid: torch.Tensor) -> torch.Tensor:
    """``h * 31 + wid`` in int32 with two's-complement wrap."""
    v = h.to(torch.int64) * 31 + wid
    return ((v + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def _hashed_viterbi(obs_pos, graph, wid, n_frames: int, every_arc: bool):
    """Max-product forward pass over [T, P] carrying each position's
    word-sequence hash; returns (alpha [P], h [P]) at frame n_frames-1.
    A position pushes its word on entry from another position
    (``every_arc=False``, hmmnet graphs) or on every frame's traversal
    (``every_arc=True``, one arc per frame in the reference convention,
    FstSearch_tmpl.hh:219-221).  Ties take the first fan-in slot."""
    in_src, in_logp = graph["in_src"][0], graph["in_logp"][0]
    entry = graph["entry"][0]
    P = in_src.shape[0]
    pos = torch.arange(P, device=obs_pos.device)
    alpha = torch.clamp(obs_pos[0] + entry, min=LOG_ZERO)
    h = torch.where((entry > LOG_ZERO / 2) & (wid > 0), wid,
                    torch.zeros_like(wid))
    for t in range(1, n_frames):
        best, arg = torch.max(alpha[in_src] + in_logp, dim=1)
        src = in_src[pos, arg]
        h_src = h[src]
        push = wid > 0 if every_arc else (src != pos) & (wid > 0)
        h = torch.where(push, _hash_push(h_src, wid), h_src)
        alpha = torch.clamp(best + obs_pos[t], min=LOG_ZERO)
    return alpha, h


def _confidences(alpha, h, final, obs, n_frames: int, best_acu: bool):
    """(grammar log-prob, best log-prob of a hypothesis with another word
    sequence, sum over frames of the best state) in one fetch."""
    fv = alpha + final
    bestp = torch.argmax(fv)
    diff = torch.where((h != h[bestp]) & (alpha > LOG_ZERO / 2), alpha,
                       torch.full((), -torch.inf, device=alpha.device))
    acu = (obs[:n_frames].max(dim=1).values.sum() if best_acu
           else torch.zeros((), device=alpha.device))
    g, d, a = torch.stack([fv[bestp], diff.max(), acu]).tolist()
    return g, d, a


class FstSearch:
    """Decoder over one precomposed FST (FstSearch.hh:39-45 API)."""

    def __init__(self, fst_path_or_fst, model, table: TransitionTable
                 | None = None, acoustic_scale: float = 1.0,
                 device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        fst = (fst_path_or_fst if isinstance(fst_path_or_fst, Fst)
               else read_fst(fst_path_or_fst))
        self.fst = fst
        self.table = table or TransitionTable.from_model(model)
        self.model = model
        graph, emit = compile_hmmnet(fst, self.table,
                                     acoustic_scale=acoustic_scale)
        self.graph = estep.stack_graphs([graph], self.device)
        self.positions_to_arc = emit
        # output word per position (emitting arc)
        self.out_label = [fst.arcs[a].out_label for a in emit]

    def _obs(self, state_log_probs) -> torch.Tensor:
        return torch.as_tensor(np.asarray(state_log_probs, np.float32),
                               device=self.device)

    def _obs_pos(self, obs: torch.Tensor) -> torch.Tensor:
        g = self.graph
        return obs[:, g["pdf"][0]] + g["obs_const"][0]

    def run(self, state_log_probs: np.ndarray,
            n_frames: int | None = None):
        """Decode [T, S] state log-probs -> (words, log_prob, path)."""
        obs = self._obs(state_log_probs)
        if n_frames is None:
            n_frames = obs.shape[0]
        n = torch.full((1,), int(n_frames), dtype=torch.int64,
                       device=self.device)
        path, score = estep.masked_viterbi(self._obs_pos(obs)[None],
                                           self.graph, n)
        path = path[0].cpu().numpy()
        words = []
        prev = -1
        for t in range(n_frames):
            p = int(path[t])
            if p != prev:  # new arc traversal emits its output label
                w = self.out_label[p] if p < len(self.out_label) else ""
                if w:
                    words.append(w)
            prev = p
        return words, float(score[0]), path

    def get_result_and_logprob(self, lna_path: str):
        """LNA file -> (result string, log prob) (FstSearch.hh:44)."""
        lp, _ = read_lna(lna_path)
        words, score, _ = self.run(lp)
        return " ".join(words), score


def _clean(s: str) -> str:
    """remove_junk (FstConfidence.cc:112-121): drop spaces, collapse
    repeated characters."""
    out = []
    prev = " "
    for c in s:
        if c == " " or c == prev:
            continue
        prev = c
        out.append(c)
    return "".join(out)


def _levenshtein(a: str, b: str) -> int:
    la, lb = len(a), len(b)
    row = list(range(lb + 1))
    for i in range(1, la + 1):
        prev, row[0] = row[0], i
        for j in range(1, lb + 1):
            cur = min(row[j] + 1, row[j - 1] + 1,
                      prev + (a[i - 1] != b[j - 1]))
            prev, row[j] = row[j], cur
    return row[lb]


class FstConfidence(FstSearch):
    """Confidence-scored grammar decoding (`decoder/src/FstConfidence.
    {hh,cc}`): confidence = 0.5 * (grammar-token + best-acoustic).

    * best-acoustic (`::grammar_token_and_best_acu_confidence`,
      FstConfidence.cc:8-45): 1.5 - 0.25*(sum_t max_s obs[t,s]
      - grammar_logprob)/T — how far the grammar path trails a free
      per-frame best-state path.
    * grammar-token: 0.2 - 5*(best_different_hypo - grammar_logprob)/T
      clamped to [0, 1], where best_different_hypo is the best-scoring
      hypothesis whose WORD SEQUENCE differs from the winner's: a
      rolling word-sequence hash per position through the Viterbi pass,
      maxed over the positions with a different hash.
    """

    logprob_conf_weight = 2.0      # API parity (FstConfidence.cc:4)
    logprob_conf_hysteresis = 100.0

    def _viterbi_with_hash(self, obs, n_frames):
        g = self.graph
        P = g["pdf"].shape[1]
        wid = torch.as_tensor(
            [_word_id(w) for w in self.out_label]
            + [0] * (P - len(self.out_label)), dtype=torch.int32,
            device=self.device)
        alpha, h = _hashed_viterbi(self._obs_pos(obs), g, wid, n_frames,
                                   every_arc=False)
        return _confidences(alpha, h, g["final"][0], obs, n_frames, True)

    def run_with_confidence(self, state_log_probs, n_frames=None):
        obs = self._obs(state_log_probs)
        if n_frames is None:
            n_frames = obs.shape[0]
        words, score, _ = self.run(state_log_probs, n_frames)
        grammar_lp, best_diff_lp, best_acu = self._viterbi_with_hash(
            obs, int(n_frames))
        T = max(int(n_frames), 1)
        ba_conf = 1.5 - 0.25 * (best_acu - grammar_lp) / T
        if not np.isfinite(best_diff_lp):
            gt_conf = 1.0
        else:
            gt_conf = min(1.0, max(
                0.0, 0.2 - 5.0 * (best_diff_lp - grammar_lp) / T))
        self.token_conf = gt_conf
        self.best_acu_conf = ba_conf
        return words, score, 0.5 * (gt_conf + min(1.0, ba_conf))

    def result_and_confidence(self, lna_path: str):
        """(result string, confidence) (FstConfidence.hh:29-34)."""
        lp, _ = read_lna(lna_path)
        words, _, conf = self.run_with_confidence(lp)
        return " ".join(words), conf


class FstConfidenceWithPhoneLoop(FstConfidence):
    """Grammar decode judged against a free phone loop
    (`FstConfidenceWithPhoneLoop`, FstConfidence.cc:87-153):
    confidence = (ploop + 20*token + 5*edit + best_acu) / 27 with
    ploop = 1 - 0.25*(ploop_lp - grammar_lp)/T and edit = 1 -
    levenshtein(clean(grammar), clean(ploop)) / len(clean(grammar))."""

    def __init__(self, grammar_fst, phone_loop_fst, model,
                 table=None, acoustic_scale: float = 1.0,
                 device: torch.device | str = "cuda"):
        super().__init__(grammar_fst, model, table, acoustic_scale, device)
        self.phone_fst = FstSearch(phone_loop_fst, model, table,
                                   acoustic_scale, self.device)
        self.ploop_logprob_weight = 0.8     # API parity

    def result_and_confidence(self, lna_path: str):
        lp, _ = read_lna(lna_path)
        return self.result_and_confidence_from_probs(lp)

    def result_and_confidence_from_probs(self, state_log_probs,
                                         n_frames=None):
        obs = np.asarray(state_log_probs, np.float32)
        if n_frames is None:
            n_frames = obs.shape[0]
        T = max(int(n_frames), 1)
        words, grammar_lp, conf0 = self.run_with_confidence(obs, n_frames)
        pwords, ploop_lp, _ = self.phone_fst.run(obs, n_frames)
        ploop_conf = min(1.0, 1.0 - 0.25 * (ploop_lp - grammar_lp) / T)
        res = " ".join(words)
        ploop_s = " ".join(pwords)
        cg = _clean(res)
        edit_conf = (max(0.0, 1.0 - _levenshtein(cg, _clean(ploop_s))
                         / len(cg)) if cg else 0.0)
        self.ploop_conf = ploop_conf
        self.edit_conf = edit_conf
        conf = (min(1.0, ploop_conf) + 20.0 * min(1.0, self.token_conf)
                + 5.0 * min(1.0, edit_conf)
                + min(1.0, self.best_acu_conf)) / 27.0
        return res, conf


# ---------------------------------------------------------------------------
# Reference-convention (mitfst) precomposed search networks


class MitFst:
    """A search FST read with the REFERENCE conventions (`Fst.cc:10-104`):
    arc field 3 is the emission pdf of the TARGET node (moved onto the
    node at read time, conflicting assignments rejected), field 4 the
    output symbol (',' = none), field 5 an embedded weight; 'F' lines
    mark any number of end nodes."""

    def __init__(self):
        self.initial = -1
        self.node_pdf: list[int] = []
        self.node_end: list[bool] = []
        self.arcs: list[tuple[int, int, str, float]] = []  # src,tgt,out,w

    def _node(self, i):
        while len(self.node_pdf) <= i:
            self.node_pdf.append(-1)
            self.node_end.append(False)

    @classmethod
    def read(cls, path_or_text: str) -> "MitFst":
        if "\n" in path_or_text:
            lines = path_or_text.splitlines()
        else:
            with open(path_or_text) as f:
                lines = f.read().splitlines()
        if not lines or lines[0].strip() != "#FSTBasic MaxPlus":
            raise ValueError("unknown FST header")
        fst = cls()
        for line in lines[1:]:
            fields = line.split()
            if not fields:
                continue
            kind, a = fields[0], int(fields[1])
            fst._node(a)
            if kind == "I":
                fst.initial = a
            elif kind == "F":
                fst.node_end[a] = True
            elif kind == "T":
                b = int(fields[2])
                fst._node(b)
                out = (fields[4] if len(fields) >= 5
                       and fields[4] != "," else "")
                w = float(fields[5]) if len(fields) >= 6 else 0.0
                fst.arcs.append((a, b, out, w))
                # atoi() semantics of Fst.cc:85: ',' parses to 0
                pdf = (int(fields[3]) if len(fields) >= 4
                       and fields[3] not in (",", "") else 0)
                if fst.node_pdf[b] == -1:
                    fst.node_pdf[b] = pdf
                elif fst.node_pdf[b] != pdf:
                    raise ValueError(
                        f"conflicting emission pdf for node {b}")
            else:
                raise ValueError(f"bad line: {line}")
        return fst


class MitFstSearch:
    """Decoder over a reference-convention precomposed search FST (the
    `final.fst` of the mitfst H/C/L/G pipeline, `FstSearch.hh:4-14`)
    with the reference's token semantics (`FstSearch_tmpl.hh:179-240`):
    every frame traverses exactly one arc (no epsilon closure), the
    target node's pdf is emitted, the embedded arc weight is scaled by
    transition_scale, and at node change the gamma duration bonus for
    the source node's pdf is added with the token's accumulated state
    duration (`FstAcoustics.cc:91-101`).

    Compiled on the host to a dense (arc x duration) position graph run
    by the masked Viterbi on the device: durations are exact up to
    max_dur, where the expansion saturates (a run longer than max_dur
    frames keeps the max_dur bonus).

    The reference binary itself never applies the duration model
    (`FstAcoustics::duration_read` resizes the a/b tables and then
    push_backs every entry, FstAcoustics.cc:77-87, leaving zeros at the
    indices it reads), so reference parity holds at duration_scale=0;
    the duration path implements the intended semantics, held against
    exhaustive token passing."""

    def __init__(self, fst, model=None, duration_scale: float = 0.0,
                 transition_scale: float = 1.0, max_dur: int = 32,
                 device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        self.fst = fst = (fst if isinstance(fst, MitFst)
                          else MitFst.read(fst))
        self.duration_scale = duration_scale
        self.transition_scale = transition_scale
        A = len(fst.arcs)
        if fst.initial < 0 or A == 0:
            raise ValueError("FST has no initial node or no arcs")
        node_pdf = np.asarray(fst.node_pdf, np.int64)
        S = (model.num_states if model is not None
             else int(node_pdf.max()) + 1)
        self.num_states = S

        durs = getattr(model, "durations", None)
        use_dur = duration_scale != 0.0 and durs is not None

        def dur_lp(s, d):
            a, b = durs[s]
            if a <= 0:
                return 0.0
            return duration_scale * ((a - 1) * math.log(d) - d / b
                                     - a * math.log(b) - math.lgamma(a))

        src = np.asarray([a[0] for a in fst.arcs], np.int64)
        tgt = np.asarray([a[1] for a in fst.arcs], np.int64)
        self_loop = src == tgt
        Dmax = max_dur if use_dur else 1

        # expanded positions: (arc, dur=1) for every arc, then
        # (arc, dur=2..Dmax) for self-loop arcs only (state_dur can
        # exceed 1 only by traversing a self loop)
        pos_arc = list(range(A))
        pos_dur = [1] * A
        block = {}                   # (arc) -> base index of durs 2..
        for a in np.flatnonzero(self_loop):
            block[int(a)] = len(pos_arc)
            for d in range(2, Dmax + 1):
                pos_arc.append(int(a))
                pos_dur.append(d)
        P = len(pos_arc)
        pos_arc = np.asarray(pos_arc, np.int64)
        pos_dur = np.asarray(pos_dur, np.int64)
        self.pos_arc, self.pos_dur = pos_arc, pos_dur

        def pos_of(arc, d):
            return arc if d <= 1 else block[arc] + (d - 2)

        pdfp = node_pdf[tgt[pos_arc]]
        pdf_pos = np.where(pdfp >= 0, pdfp, S)
        obs_const = (transition_scale *
                     np.asarray([a[3] for a in fst.arcs], np.float32))

        entry = np.full(P, LOG_ZERO, np.float32)
        entry[(src[pos_arc] == fst.initial) & (pos_dur == 1)] = 0.0
        final = np.full(P, LOG_ZERO, np.float32)
        final[np.asarray(fst.node_end, bool)[tgt[pos_arc]]] = 0.0

        out_arcs: dict[int, list[int]] = {}
        for a in range(A):
            out_arcs.setdefault(int(src[a]), []).append(a)
        edges = []                       # (src_pos, tgt_pos, weight)
        for p in range(P):
            a, d = int(pos_arc[p]), int(pos_dur[p])
            v = int(tgt[a])
            leave_pdf = int(node_pdf[v])
            leave_w = (dur_lp(leave_pdf, d)
                       if use_dur and leave_pdf >= 0 else 0.0)
            for q in out_arcs.get(v, []):
                if self_loop[q]:
                    edges.append((p, pos_of(q, min(d + 1, Dmax)), 0.0))
                else:
                    edges.append((p, q, leave_w))
        fan = np.zeros(P, np.int64)
        for (_, t, _w) in edges:
            fan[t] += 1
        F = max(int(fan.max(initial=1)), 1)
        in_src = np.tile(np.arange(P, dtype=np.int64)[:, None], (1, F))
        in_logp = np.full((P, F), LOG_ZERO, np.float32)
        k = np.zeros(P, np.int64)
        for (s_, t_, w_) in edges:
            in_src[t_, k[t_]] = s_
            in_logp[t_, k[t_]] = w_
            k[t_] += 1
        self.graph = estep.stack_graphs([{
            "in_src": in_src, "in_logp": in_logp, "entry": entry,
            "final": final, "num_positions": np.int64(P)}], self.device)
        self.pdf_pos = torch.as_tensor(pdf_pos, device=self.device)
        self.obs_const = torch.as_tensor(obs_const[pos_arc],
                                         device=self.device)
        self.out_label = [fst.arcs[a][2] for a in range(A)]

    def _obs_pos(self, state_log_probs):
        """([T, S] observations, [T, P] position scores); column S of
        the extended observations is 0.0 for non-emitting target
        nodes."""
        obs = torch.as_tensor(np.asarray(state_log_probs, np.float32),
                              device=self.device)
        obs_ext = torch.cat([obs, torch.zeros((obs.shape[0], 1),
                                              device=self.device)], dim=1)
        return obs, obs_ext[:, self.pdf_pos] + self.obs_const

    def run(self, state_log_probs, n_frames: int | None = None):
        """Decode [T, S] state log-probs -> (words, log_prob, path)."""
        _obs, obs_pos = self._obs_pos(state_log_probs)
        if n_frames is None:
            n_frames = obs_pos.shape[0]
        n = torch.full((1,), int(n_frames), dtype=torch.int64,
                       device=self.device)
        path, score = estep.masked_viterbi(obs_pos[None], self.graph, n)
        path = path[0].cpu().numpy()
        words = []
        for t in range(n_frames):          # one arc traversal per frame
            w = self.out_label[int(self.pos_arc[path[t]])]
            if w:
                words.append(w)
        return words, float(score[0]), path

    def get_result_and_logprob(self, lna_path: str):
        """LNA file -> (result string, log prob) (FstSearch.hh:44)."""
        lp, _ = read_lna(lna_path)
        words, score, _ = self.run(lp)
        return " ".join(words), score

    def run_with_confidence(self, state_log_probs,
                            n_frames: int | None = None,
                            accumulate_best_acu: bool = True):
        """(words, logprob, confidence) with the FstConfidence formulas
        (`FstConfidence.cc:8-78`) over the mit-convention graph.

        confidence = 0.5*(gt + ba); gt = clamp(0.2 - 5*(best_diff -
        lp)/T), ba = 1.5 - 0.25*(best_acu - lp)/T.  The reference's
        plain `FstConfidence::run` (FstConfidence.hh:21-27) never adds
        to m_best_acu_score -- only the phone-loop variant accumulates
        it (FstConfidence.cc:104) -- so for value parity with the plain
        class pass accumulate_best_acu=False (best_acu stays 0).
        """
        obs, obs_pos = self._obs_pos(state_log_probs)
        if n_frames is None:
            n_frames = obs.shape[0]
        words, lp, _ = self.run(state_log_probs, n_frames)
        wid = torch.as_tensor(
            [_word_id(self.out_label[int(a)]) for a in self.pos_arc],
            dtype=torch.int32, device=self.device)
        alpha, h = _hashed_viterbi(obs_pos, self.graph, wid, int(n_frames),
                                   every_arc=True)
        _g, best_diff, best_acu = _confidences(
            alpha, h, self.graph["final"][0], obs, int(n_frames),
            accumulate_best_acu)
        T_ = max(int(n_frames), 1)
        ba = 1.5 - 0.25 * (best_acu - lp) / T_
        if not np.isfinite(best_diff):
            gt = 1.0
        else:
            gt = min(1.0, max(0.0, 0.2 - 5.0 * (best_diff - lp) / T_))
        self.token_conf, self.best_acu_conf = gt, ba
        return words, lp, 0.5 * (gt + ba)
