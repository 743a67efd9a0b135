"""Toolbox: the decoder facade of the reference's SWIG surface.

Counterpart of `aaltoasr_tpu/decoder/toolbox.py` (the reference's
`decoder/src/Toolbox.{hh,cc}`): loads the .ph/.dur topology, a lexicon
and an ARPA LM, owns the search knobs, and decodes LNA files or state
log-probs with the exact engine (`search.BeamSearch`) on ``device``: the
GPU unless the caller passes ``device="cpu"``.  The loading calls
(ARPA or binary LMs, HTK lattices as grammars) and setters are those
`recognize` and `decode` use; options not ported yet raise
NotImplementedError in their setter, before any decode.
"""

from __future__ import annotations

import numpy as np
import torch

from aaltoasr_tpu_torch.decoder.lexicon import (
    PrefixTree, build_prefix_tree, read_lexicon)
from aaltoasr_tpu_torch.decoder.ngram import NGramFsa
from aaltoasr_tpu_torch.decoder.search import (
    EXACT_REST_ITEM, BeamSearch, SearchConfig)
from aaltoasr_tpu_torch.decoder.slf import SlfLattice, lattice_grammar
from aaltoasr_tpu_torch.device import resolve_device
from aaltoasr_tpu_torch.formats.arpa import read_arpa
from aaltoasr_tpu_torch.formats.lna import read_lna
from aaltoasr_tpu_torch.formats.model_io import HmmModel, read_dur, read_ph
from aaltoasr_tpu_torch.formats.treegram_bin import read_bin


class Toolbox:
    """Decoder facade (Toolbox.hh:29-319 API shape)."""

    def __init__(self, hmm_path: str, dur_path: str = "",
                 device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        phones, transitions = read_ph(hmm_path)
        num_states = 1 + max((s for p in phones for s in p.states),
                             default=0)
        # topology + durations only: acoustics arrive as LNA log-probs
        self.model = HmmModel(
            dim=0, cov_type="diagonal_cov",
            means=np.zeros((0, 1)), covars=np.zeros((0, 1)),
            mixtures=[(np.zeros(0, np.int32), np.zeros(0))] * num_states,
            phones=phones, transitions=transitions)
        if dur_path:
            self.model.durations = read_dur(dur_path)
        self.tree: PrefixTree | None = None
        self.lm: NGramFsa | None = None
        self.lookahead_lm: NGramFsa | None = None
        self._search: BeamSearch | None = None
        self.config = SearchConfig()
        self._word_boundary = ""
        self._silence_is_word = True
        self._optional_short_silence = False
        self._generate_word_graph = False

    # -- model/lexicon/LM loading (Toolbox.hh:42-108) ---------------------
    def lex_read(self, path) -> None:
        self.tree = build_prefix_tree(
            self.model, read_lexicon(path),
            silence_is_word=self._silence_is_word,
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

    def ngram_read(self, path, binary: bool = False) -> None:
        """An ARPA LM, or a binary TreeGram one with ``binary``."""
        lm = read_bin(path) if binary else read_arpa(path)
        self.lm = NGramFsa.from_arpa(lm)
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
        """0 off, 1 unigram table, 2 bigram table (the reference's
        lm_lookahead, TokenPassSearch.cc:2015)."""
        if int(mode) >= 3:
            raise NotImplementedError(
                f"context lookahead (mode 3) is not ported yet "
                f"({EXACT_REST_ITEM})")
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

    def set_require_sentence_end(self, value: bool):
        """Add P(</s>|history) when ranking final hypotheses
        (Toolbox.hh:284)."""
        self.config.require_sentence_end = bool(value)
        self._search = None

    def set_generate_word_graph(self, value) -> None:
        """The reference opts in to word-graph bookkeeping (Toolbox.hh:
        300); here every decode with lattice=True keeps the records, and
        this flag makes `lna_decode` keep them whatever it is asked."""
        self._generate_word_graph = bool(value)

    # -- decoding ---------------------------------------------------------
    def _ensure_search(self) -> BeamSearch:
        if self.tree is None:
            raise RuntimeError("lexicon not loaded (lex_read)")
        if self.lm is None:
            raise RuntimeError("language model not loaded (ngram_read)")
        if self._search is None:
            self._search = BeamSearch(
                self.tree, self.lm, self.model, self.config,
                lookahead_lm=self.lookahead_lm, device=self.device)
        return self._search

    def decode(self, state_log_probs: np.ndarray,
               n_frames: int | None = None, lattice: bool = True):
        """[T, S] state log-probs -> result, iterable as (words,
        log_prob); lattice=False fetches only the 1-best's records."""
        return self._ensure_search().decode(state_log_probs, n_frames,
                                            lattice=lattice)

    def decode_batch(self, state_log_probs: np.ndarray,
                     n_frames: np.ndarray, lattice: bool = True):
        return self._ensure_search().decode_batch(state_log_probs, n_frames,
                                                  lattice=lattice)

    def lna_decode(self, lna_path: str, lattice: bool = True):
        """Decode one LNA file (lna_open + run loop equivalent)."""
        lp, _ = read_lna(lna_path)
        return self.decode(lp, lattice=lattice or self._generate_word_graph)
