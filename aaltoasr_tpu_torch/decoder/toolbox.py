"""Toolbox: the decoder facade of the reference's SWIG surface.

Counterpart of `aaltoasr_tpu/decoder/toolbox.py` (the reference's
`decoder/src/Toolbox.{hh,cc}`): loads the .ph/.dur topology, a lexicon
and an ARPA LM, owns the search knobs, and decodes LNA files or state
log-probs with the exact engine (`search.BeamSearch`) on ``device``: the
GPU unless the caller passes ``device="cpu"``.  It has the reference
package's whole surface: the loading calls (ARPA, binary, interpolated
and lookahead LMs, HTK lattices as grammars, word classes, the HMM and
duration files), the search knobs and pruning beams, the API-parity
flags, and push-model decoding (`use_one_frame_acoustics`,
`set_one_frame`, `run`, `stream_result`).  State segmentation is not
ported yet (ROADMAP queue 1 item 5: training, its hmmnet half, whose
HMM networks it aligns on; training on transcript chains is ported).
"""

from __future__ import annotations

import math
from dataclasses import replace

import numpy as np
import torch

from aaltoasr_tpu_torch.decoder.classes import WordClasses
from aaltoasr_tpu_torch.decoder.lexicon import (
    PrefixTree, build_prefix_tree, read_lexicon)
from aaltoasr_tpu_torch.decoder.ngram import InterNGramFsa, NGramFsa
from aaltoasr_tpu_torch.decoder.search import (
    BeamSearch, SearchConfig, StreamingDecoder)
from aaltoasr_tpu_torch.decoder.slf import SlfLattice, lattice_grammar
from aaltoasr_tpu_torch.device import resolve_device
from aaltoasr_tpu_torch.formats.arpa import ArpaLM, read_arpa
from aaltoasr_tpu_torch.formats.lna import read_lna
from aaltoasr_tpu_torch.formats.model_io import HmmModel, read_dur, read_ph
from aaltoasr_tpu_torch.formats.treegram_bin import read_bin


class Toolbox:
    """Decoder facade (Toolbox.hh:29-319 API shape)."""

    def __init__(self, hmm_path: str, dur_path: str = "",
                 device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        self.model = _topology(hmm_path)
        if dur_path:
            self.model.durations = read_dur(dur_path)
        self.tree: PrefixTree | None = None
        self.lm: NGramFsa | InterNGramFsa | None = None
        self.lookahead_lm: NGramFsa | None = None
        self._search: BeamSearch | None = None
        self._stream: StreamingDecoder | None = None
        self.config = SearchConfig()
        self._word_boundary = ""
        self._sentence_start = "<s>"
        self._sentence_end = "</s>"
        self._word_classes: WordClasses | None = None
        self._silence_is_word = True
        self._optional_short_silence = False
        self._cross_word = None
        self._ignore_case = False
        self._generate_word_graph = False
        self._end_frame = -1

    # -- model/lexicon/LM loading (Toolbox.hh:42-108) ---------------------
    def lex_read(self, path) -> None:
        entries = read_lexicon(path)
        if self._ignore_case:
            entries = [replace(e, word=e.word.lower()) for e in entries]
        self.tree = build_prefix_tree(
            self.model, entries,
            silence_is_word=self._silence_is_word,
            cross_word=self._cross_word,
            optional_short_silence=self._optional_short_silence,
            word_boundary=self._word_boundary)
        self._search = None

    def set_silence_is_word(self, value) -> None:
        """'_'-initial lexicon words carry LM scores when true
        (Toolbox.hh:251, TPNowayLexReader.cc:153)."""
        self._silence_is_word = bool(value)
        self._search = None

    def set_optional_short_silence(self, value) -> None:
        """Cross an optional 1-state silence between words
        (Toolbox.hh:292, TPLexPrefixTree.cc:132-141)."""
        self._optional_short_silence = bool(value)
        self._search = None

    def set_cross_word_triphones(self, value) -> None:
        """Build cross-word fan-in/fan-out networks (Toolbox.hh:245);
        lex_read passes it to the tree builder."""
        self._cross_word = bool(value)
        self._search = None

    def ngram_read(self, path, binary: bool = False) -> None:
        """An ARPA LM, or a binary TreeGram one with ``binary``."""
        lm = read_bin(path) if binary else read_arpa(path)
        self.lm = NGramFsa.from_arpa(lm)
        self._search = None

    def fsa_lm_read(self, path, binary: bool = False) -> None:
        """The n-gram LM already decodes as an FSA: the same entry point."""
        self.ngram_read(path, binary)

    def interpolated_ngram_read(self, paths: list, weights: list) -> None:
        """Decode with a linear interpolation of several n-gram models
        (Toolbox::interpolated_ngram_read, Toolbox.cc:156-163): the search
        walks every member FSA and mixes scores in the probability
        domain."""
        self.lm = InterNGramFsa.from_arpas([read_arpa(p) for p in paths],
                                           list(weights))
        self._search = None

    def interpolated_lookahead_ngram_read(self, paths, weights) -> None:
        """Interpolated lookahead LM (Toolbox.hh:77): the members are
        pre-mixed into one backoff FSA, the union of their n-grams scored
        by the probability-domain mixture (each member walked with its own
        backoffs).  Lookahead only ranks and prunes, so the mixed model's
        zero backoff weights make unseen contexts optimistic
        (admissible)."""
        lms = [read_arpa(p) for p in paths]
        lw = [math.log(w) for w in weights]
        vocab: list = []
        wi: dict = {}
        for m in lms:
            for w in m.vocab:
                if w not in wi:
                    wi[w] = len(vocab)
                    vocab.append(w)
        order = max(m.order for m in lms)
        grams: list = [{} for _ in range(order + 1)]
        for m in lms:
            for o in range(1, m.order + 1):
                for key in m.ngrams[o]:
                    words = tuple(m.vocab[k] for k in key)
                    gkey = tuple(wi[w] for w in words)
                    if gkey in grams[o]:
                        continue
                    tot = -float("inf")
                    for m2, w2 in zip(lms, lw):
                        if any(x not in m2.word_index for x in words):
                            continue
                        ctx = tuple(m2.word_index[x] for x in words[:-1])
                        sc = m2.log_prob(ctx, m2.word_index[words[-1]])
                        tot = np.logaddexp(tot, w2 + sc)
                    grams[o][gkey] = (float(tot), 0.0)
        self.lookahead_lm = NGramFsa.from_arpa(
            ArpaLM(order=order, vocab=vocab, word_index=wi, ngrams=grams))
        self._search = None

    def hmm_read(self, path: str) -> None:
        """Re-load the HMM topology (Toolbox.hh:42), keeping the
        durations; the lexicon must be read again."""
        durs = getattr(self.model, "durations", None)
        self.model = _topology(path)
        self.model.durations = durs
        self.tree = None
        self._search = None

    def duration_read(self, path: str) -> None:
        """Load gamma duration parameters (.dur, Toolbox.hh:44)."""
        self.model.durations = read_dur(path)
        self._search = None

    def read_word_classes(self, path) -> None:
        """Class-based LM definitions (decoder/src/WordClasses.cc): class
        names are the LM words, membership log-probs join the
        pronunciation scores."""
        self._word_classes = WordClasses.read(path)
        self._search = None

    def htk_lattice_grammar_read(self, path) -> None:
        """Use an HTK SLF lattice as the grammar
        (Toolbox::htk_lattice_grammar_read, Toolbox.cc:199-220): the
        decode is constrained to word sequences the lattice accepts."""
        self.lm = lattice_grammar(SlfLattice.read(path))
        self._search = None

    def read_lookahead_ngram(self, path) -> None:
        """Separate (smaller) LM for lookahead scores
        (Toolbox::read_lookahead_ngram)."""
        self.lookahead_lm = NGramFsa.from_arpa(read_arpa(path))
        self._search = None

    def set_lm_lookahead(self, mode: int) -> None:
        """0 off, 1 unigram table, 2 bigram table, 3 context (>= trigram)
        lookahead (the reference's lm_lookahead modes 1 = bigram, 2 =
        trigram, TokenPassSearch.cc:2015/2084)."""
        self.config.lm_lookahead = int(mode)
        self._search = None

    # -- tuning knobs (Toolbox.hh:182-319) --------------------------------
    def set_global_beam(self, b: float):
        self.config.beam = b
        self._search = None

    def set_token_limit(self, limit: int):
        # fixed-width token array: the analog of prune_tokens' limit
        self.config.num_tokens = int(limit)
        self._search = None

    def set_lm_scale(self, s: float):
        self.config.lm_scale = s
        self._search = None

    def set_duration_scale(self, s: float):
        self.config.duration_scale = s
        self._search = None

    def set_transition_scale(self, s: float):
        self.config.transition_scale = s
        self._search = None

    def set_insertion_penalty(self, p: float):
        self.config.insertion_penalty = p
        self._search = None

    def set_overflow_tokens(self, n: int):
        """Branch-expansion budget (SearchConfig.overflow_tokens): 0 =
        every arc of every token."""
        self.config.overflow_tokens = int(n)
        self._search = None

    def set_we_prewalk(self, n: int):
        """Walk the LM only for the top-n word ends ranked by a static
        unigram estimate; 0 = walk everything."""
        self.config.we_prewalk = int(n)
        self._search = None

    def set_word_end_beam(self, b: float):
        """Prune word ends vs the frame's best word end (Toolbox.hh:205,
        TokenPassSearch.cc:1076-1081); 0 = off."""
        self.config.word_end_beam = float(b)
        self._search = None

    def set_reentry_prewalk(self, n: int):
        """Each re-entering word end keeps its top-n cross-word entry
        nodes, ranked by root arc + entry obs; 0 = all."""
        self.config.reentry_prewalk = int(n)
        self._search = None

    def set_reentry_records(self, n: int):
        """Only the top-n record slots (best first) re-enter; all
        records are still written.  0 = all re-enter."""
        self.config.reentry_records = int(n)
        self._search = None

    def set_eq_depth_beam(self, b: float):
        """Prune vs the best same-tree-depth candidate (EQ_DEPTH_PRUNING,
        TokenPassSearch.cc:1083-1096); 0 = off."""
        self.config.eq_depth_beam = float(b)
        self._search = None

    def set_eq_word_count_beam(self, b: float):
        """Prune vs the best candidate with the same committed-word count
        (EQ_WC_PRUNING, TokenPassSearch.cc:1097-1106); 0 = off."""
        self.config.eq_word_count_beam = float(b)
        self._search = None

    def set_fan_in_beam(self, b: float):
        """Prune fan-in-network candidates vs the best fan-in candidate
        (FAN_IN_PRUNING, Toolbox.hh:209); 0 = off."""
        self.config.fan_in_beam = float(b)
        self._search = None

    def set_fan_out_beam(self, b: float):
        """Prune fan-out candidates vs the best fan-out candidate
        (FAN_OUT_PRUNING, Toolbox.hh:213); 0 = off."""
        self.config.fan_out_beam = float(b)
        self._search = None

    def set_tp_state_beam(self, b: float):
        """At fan nodes: prune vs the best candidate at the same node
        (STATE_PRUNING, TokenPassSearch.cc:1116-1127); 0 = off."""
        self.config.tp_state_beam = float(b)
        self._search = None

    def set_split_multiwords(self, value: bool):
        """Score multiwords ("give_me") as their component-word sequence
        in the LM (Toolbox.hh:223-232).  Words starting with '_' are
        silences and never split."""
        self.config.split_multiwords = bool(value)
        self._search = None

    def set_word_boundary(self, word: str):
        """Morph-mode word boundary ('<w>'), rectool.py:563-564: the
        short-silence nodes commit it as an LM word, two subsequent
        boundaries are pruned, and mid-utterance sentence ends restart
        the LM through <s> + boundary (call before lex_read, like the
        reference, Toolbox.cc:395-403)."""
        self._word_boundary = word
        self.config.word_boundary = word
        self._search = None

    def set_sentence_boundary(self, start: str, end: str):
        """The sentence start the LM history begins with, and the end
        word of require_sentence_end (Toolbox.hh:256)."""
        self._sentence_start = start
        self._sentence_end = end
        self.config.sentence_end = end
        self._search = None

    def set_require_sentence_end(self, value: bool):
        """Add P(</s>|history) when ranking final hypotheses
        (Toolbox.hh:284)."""
        self.config.require_sentence_end = bool(value)
        self._search = None

    # -- API-parity flags: the reference's roles of these are subsumed by
    # the array design (each says how) ---------------------------------------
    def set_generate_word_graph(self, value) -> None:
        """The reference opts in to word-graph bookkeeping (Toolbox.hh:
        300); here every decode with lattice=True keeps the records, and
        this flag makes `lna_decode` keep them whatever it is asked."""
        self._generate_word_graph = bool(value)

    def set_ignore_case(self, value) -> None:
        """Lowercase lexicon words on read (Toolbox.hh:249)."""
        self._ignore_case = bool(value)

    def set_prune_similar(self, n: int) -> None:
        """The reference prunes tokens whose last-n-word histories match
        (find_similar_lm_history, TokenPassSearch.cc:1312); recombination
        here keys on the full LM state, exact for the 1-best and stronger
        than any finite span."""
        self._prune_similar = int(n)

    def set_use_word_pair_approximation(self, value) -> None:
        """The reference can recombine by word pairs (TokenPassSearch.hh:
        160); here recombination is always on the exact LM state."""
        self._word_pair_approx = bool(value)

    def set_use_lm_cache(self, value) -> None:
        """The reference caches LM lookups (Toolbox.hh:220); the
        vectorized walk needs no cache."""
        self._use_lm_cache = bool(value)

    def prune_lm_lookahead_buffers(self, min_delta, max_depth) -> None:
        """The reference's lookahead-cache sizing (Toolbox.hh:80); the
        lookahead tables here are precomputed, with nothing to prune."""

    def set_remove_pronunciation_id(self, value) -> None:
        """Strip '(N)' pronunciation ids from output words (Toolbox.hh:
        255); the lexicon keeps variants under one word name, so outputs
        carry no ids."""
        self._remove_pron_id = bool(value)

    def set_verbose(self, level: int) -> None:
        self._verbose = int(level)

    def set_print_probs(self, value) -> None:
        self._print_probs = bool(value)

    def set_print_text_result(self, value) -> None:
        self._print_text_result = bool(value)

    def set_end(self, frame: int) -> None:
        """Stop decoding at this frame (-1 = the whole input,
        Toolbox.hh:139); `lna_decode` reads it."""
        self._end_frame = int(frame)

    # -- decoding ---------------------------------------------------------
    def _ensure_search(self) -> BeamSearch:
        if self.tree is None:
            raise RuntimeError("lexicon not loaded (lex_read)")
        if self.lm is None:
            raise RuntimeError("language model not loaded (ngram_read)")
        if self._search is None:
            self._search = BeamSearch(
                self.tree, self.lm, self.model, self.config,
                word_classes=self._word_classes,
                lookahead_lm=self.lookahead_lm, device=self.device)
        return self._search

    def decode(self, state_log_probs: np.ndarray,
               n_frames: int | None = None, lattice: bool = True):
        """[T, S] state log-probs -> result, iterable as (words,
        log_prob); lattice=False fetches only the 1-best's records."""
        return self._ensure_search().decode(
            state_log_probs, n_frames, sentence_start=self._sentence_start,
            lattice=lattice)

    def decode_batch(self, state_log_probs: np.ndarray,
                     n_frames: np.ndarray, lattice: bool = True):
        return self._ensure_search().decode_batch(
            state_log_probs, n_frames, sentence_start=self._sentence_start,
            lattice=lattice)

    def lna_decode(self, lna_path: str, lattice: bool = True):
        """Decode one LNA file (lna_open + run loop equivalent)."""
        lp, _ = read_lna(lna_path)
        if self._end_frame >= 0:
            lp = lp[:self._end_frame]
        return self.decode(lp, lattice=lattice or self._generate_word_graph)

    # -- streaming (OneFrameAcoustics; Toolbox.hh:123-145) -----------------
    def use_one_frame_acoustics(self) -> StreamingDecoder:
        """Switch to push-model acoustics; returns the StreamingDecoder."""
        self._stream = StreamingDecoder(
            self._ensure_search(), sentence_start=self._sentence_start)
        return self._stream

    def set_one_frame(self, frame: int, log_probs) -> None:
        """Push one frame of state log-probs (Toolbox::set_one_frame)."""
        if self._stream is None:
            self.use_one_frame_acoustics()
        self._stream.push_frame(log_probs)

    def run(self) -> bool:
        """The push already advanced the search; True while the stream
        is open."""
        return self._stream is not None

    def stream_result(self):
        return self._stream.result()


def _topology(hmm_path: str) -> HmmModel:
    """The .ph topology as a model without Gaussians (acoustics arrive as
    state log-probs)."""
    phones, transitions = read_ph(hmm_path)
    num_states = 1 + max((s for p in phones for s in p.states), default=0)
    return HmmModel(
        dim=0, cov_type="diagonal_cov",
        means=np.zeros((0, 1)), covars=np.zeros((0, 1)),
        mixtures=[(np.zeros(0, np.int32), np.zeros(0))] * num_states,
        phones=phones, transitions=transitions)
