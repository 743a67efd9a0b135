"""Carry the JAX package's objects across into the port's types.

Each converter reads the reference object attribute by attribute (as
numpy arrays where they are arrays) and builds the port's object, so a
test can feed both sides identical tables.  This module imports neither
jax nor the reference package: it only reads attributes of objects it
is handed.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from aaltoasr_tpu_torch.decoder.classes import WordClasses
from aaltoasr_tpu_torch.decoder.lexicon import PrefixTree
from aaltoasr_tpu_torch.decoder.ngram import InterNGramFsa, NGramFsa
from aaltoasr_tpu_torch.decoder.search import SearchConfig
from aaltoasr_tpu_torch.formats.fst import Fst, FstArc
from aaltoasr_tpu_torch.formats.model_io import HmmModel, HmmPhone
from aaltoasr_tpu_torch.models.hmm import LinearChain, TransitionTable
from aaltoasr_tpu_torch.ops.gmm import GmmScorer
from aaltoasr_tpu_torch.ops.gmm_cuda import FusedGmmScorer
from aaltoasr_tpu_torch.train.accumulators import BufferStats, HmmStats


def _copy_fields(cls, ref, **override):
    values = {}
    for f in dataclasses.fields(cls):
        if f.name in override:
            values[f.name] = override[f.name]
        else:
            v = getattr(ref, f.name)
            values[f.name] = (np.array(v) if isinstance(v, np.ndarray)
                              else copy.deepcopy(v))
    return cls(**values)


def hmm_model(ref) -> HmmModel:
    """The reference `HmmModel` (phones re-made as the port's type)."""
    phones = [HmmPhone(label=p.label, states=list(p.states))
              for p in ref.phones]
    return _copy_fields(HmmModel, ref, phones=phones)


def prefix_tree(ref) -> PrefixTree:
    return _copy_fields(PrefixTree, ref)


def ngram_fsa(ref) -> NGramFsa:
    return _copy_fields(NGramFsa, ref)


def inter_ngram_fsa(ref) -> InterNGramFsa:
    """A reference `InterNGramFsa`: its members and coefficients."""
    return InterNGramFsa([ngram_fsa(m) for m in ref.members], ref.coeffs)


def word_classes(ref) -> WordClasses:
    return WordClasses(membership=dict(ref.membership))


def search_config(ref) -> SearchConfig:
    """A reference `SearchConfig`'s knobs (every field the port has)."""
    return _copy_fields(SearchConfig, ref)


def gmm_scorer(ref, device: torch.device | str = "cpu") -> GmmScorer:
    """A reference `GmmScorer`'s tables on ``device``: diagonal or
    full-covariance, with its subspace and cluster tables."""

    def dev(a, dtype=None):
        a = np.array(a)                                    # a writable copy
        return torch.as_tensor(a if dtype is None else a.astype(dtype),
                               device=device)

    gated = ref.cluster_of is not None
    return GmmScorer(
        dim=ref.dim, num_states=ref.num_states,
        num_gaussians=ref.num_gaussians,
        score_matrix=dev(ref.score_matrix), score_bias=dev(ref.score_bias),
        comp_idx=dev(ref.comp_idx, np.int64), comp_logw=dev(ref.comp_logw),
        full_cov=ref.full_cov,
        sub_basis=tuple(dev(b) for b in ref.sub_basis),
        sub_lambda=tuple(dev(lam) for lam in ref.sub_lambda),
        cluster_of=dev(ref.cluster_of, np.int64) if gated else None,
        cluster_matrix=dev(ref.cluster_matrix) if gated else None,
        cluster_bias=dev(ref.cluster_bias) if gated else None,
        cluster_sizes=dev(ref.cluster_sizes, np.int64) if gated else None,
        min_eval_clusters=ref.min_eval_clusters,
        min_eval_gauss=ref.min_eval_gauss)


def feature_params(ref, fg) -> None:
    """Load a reference `FeatureGenerator`'s runtime parameters
    (``ref.params``, e.g. after `apply_speaker_config`) into the port's
    generator ``fg``, on its device."""
    for name, params in ref.params.items():
        fg._dev_params[name] = fg._upload(
            {k: np.asarray(v) for k, v in params.items()})


def fused_gmm_scorer(ref, device: torch.device | str = "cpu") -> FusedGmmScorer:
    """A reference `FusedGmmScorer`'s slabs on ``device``."""
    return FusedGmmScorer(dim=ref.dim, num_states=ref.num_states,
                          we=torch.as_tensor(np.array(ref.we),
                                             device=device))


def transition_table(ref) -> TransitionTable:
    return _copy_fields(TransitionTable, ref)


def linear_chain(ref) -> LinearChain:
    return _copy_fields(LinearChain, ref)


def fst(ref) -> Fst:
    """A reference MIT-FST network, arc by arc."""
    return _copy_fields(Fst, ref, arcs=[_copy_fields(FstArc, a)
                                        for a in ref.arcs])


def hmmnet_graph(ref: dict) -> dict:
    """A graph dict compiled by the reference (`compile_hmmnet`,
    `pad_hmmnet`, `shift_compile`): numpy copies of its tables."""
    return {k: np.array(v) for k, v in ref.items()}


def hmm_stats(ref) -> HmmStats:
    """A reference `HmmStats` with each of its buffers (ML, MMI, MPE
    numerator and denominator), its likelihoods and MPE score."""
    buffers = {b: _copy_fields(BufferStats, buf)
               for b, buf in ref.buffers.items()}
    return _copy_fields(HmmStats, ref, buffers=buffers)
