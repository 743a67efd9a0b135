"""Synthetic tasks of the benchmark, built with numpy alone.

Counterpart of `benchmarks/bench_decode.synth_task` / `synth_obs` and of
`__graft_entry__._random_model` / `_MFCC_CFG`: the same seeds give the
same models, trees, LMs and planted state plans.  The planted
observations' noise comes from a `torch.Generator` here (the reference
draws it with `jax.random`), so only the plan and the true words match
the reference.  `write_task` writes a task as the files the CLIs read:
.ph/.gk/.mc/.dur, feature .cfg, lexicon, ARPA LM, WAVs and a recipe.
"""

from __future__ import annotations

import dataclasses
import os
import wave
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from aaltoasr_tpu_torch.decoder.lexicon import (
    PrefixTree, _resolve_context, build_prefix_tree, read_lexicon)
from aaltoasr_tpu_torch.decoder.ngram import NGramFsa
from aaltoasr_tpu_torch.formats import model_io
from aaltoasr_tpu_torch.formats.arpa import ArpaLM, write_arpa

MFCC_CFG = """\
module
{
  name audio
  type audiofile
  sample_rate 16000
}
module
{
  name fft
  type fft
  sources audio
}
module
{
  name mel
  type mel
  sources fft
}
module
{
  name dct
  type dct
  sources mel
}
module
{
  name power
  type power
  sources fft
}
module
{
  name cat
  type merge
  sources dct power
}
module
{
  name delta
  type delta
  sources cat
  width 2
}
module
{
  name accel
  type delta
  sources delta
  width 2
}
module
{
  name out
  type merge
  sources cat delta accel
}
"""


def mfcc_cfg(rate: int = 16000, root: bool = False,
             magnitude: bool = True) -> str:
    """`MFCC_CFG` at another sample rate (window 2 * rate / 125 samples),
    with the mel 10th root or the fft power spectrum when asked."""
    text = MFCC_CFG.replace("sample_rate 16000", f"sample_rate {rate}")
    if root:
        text = text.replace("type mel\n", "type mel\n  root 1\n")
    if not magnitude:
        text = text.replace("type fft\n", "type fft\n  magnitude 0\n")
    return text


def _module(name, mtype, sources=None, **items) -> str:
    lines = [f"  name {name}", f"  type {mtype}"]
    if sources:
        lines.append(f"  sources {sources}")
    lines += [f"  {k} {v}" for k, v in items.items()]
    return "module\n{\n" + "\n".join(lines) + "\n}\n"


def _floats(a) -> str:
    return " ".join(f"{float(v):.6g}" for v in np.ravel(a))


def _normalization(source: str, norm) -> str:
    """Given ``norm`` = (mean, scale), a `norm` normalization module on
    ``source`` (the global mean and variance normalization a `feanorm`
    file holds), else nothing."""
    if norm is None:
        return ""
    mean, scale = norm
    return _module("norm", "normalization", source, mean=_floats(mean),
                   scale=_floats(scale))


def norm_stats(frames: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(mean, 1 / standard deviation) per dimension of [N, d] frames: the
    items of a normalization module that makes them zero-mean and of
    unit variance."""
    frames = np.asarray(frames, dtype=np.float64)
    return frames.mean(0), 1.0 / frames.std(0)


def splice_cfg(ceps: int = 12, out_dim: int = 39, seed: int = 0,
               norm=None) -> str:
    """Splice + LDA configuration: MFCC (``ceps`` cepstra) + power ->
    delta -> merge -> concat (left 1, right 1) -> `lda`, a fixed random
    lin_transform down to ``out_dim`` [-> `norm`, a normalization given
    ``norm``] -> `cmllr`, an identity lin_transform a speaker
    configuration replaces per speaker.  The fft -> {mel -> dct, power}
    core fuses."""
    width = 6 * (ceps + 1)
    lda = np.random.default_rng(seed).normal(
        0, 1 / np.sqrt(width), (out_dim, width))
    return (_module("audio", "audiofile", sample_rate=16000)
            + _module("fft", "fft", "audio")
            + _module("mel", "mel", "fft")
            + _module("dct", "dct", "mel", dim=ceps)
            + _module("power", "power", "fft")
            + _module("cat", "merge", "dct power")
            + _module("delta", "delta", "cat", width=2)
            + _module("both", "merge", "cat delta")
            + _module("splice", "concat", "both", left=1, right=1)
            + _module("lda", "lin_transform", "splice", dim=out_dim,
                      matrix=_floats(lda))
            + _normalization("lda", norm)
            + _module("cmllr", "lin_transform",
                      "lda" if norm is None else "norm", dim=out_dim))


def vtln_cfg(ceps: int = 12, norm=None, **vtln) -> str:
    """VTLN configuration: fft -> `vtln` (items ``vtln``, e.g.
    ``{"all-pass": 1}``) -> mel -> dct, with power, deltas and
    accelerations: 3 * (ceps + 1) features [-> `norm`, a normalization
    given ``norm``].  It does not fuse (the fft feeds the vtln
    module)."""
    return (_module("audio", "audiofile", sample_rate=16000)
            + _module("fft", "fft", "audio")
            + _module("vtln", "vtln", "fft", **vtln)
            + _module("mel", "mel", "vtln")
            + _module("dct", "dct", "mel", dim=ceps)
            + _module("power", "power", "fft")
            + _module("cat", "merge", "dct power")
            + _module("delta", "delta", "cat", width=2)
            + _module("accel", "delta", "delta", width=2)
            + _module("out", "merge", "cat delta accel")
            + _normalization("out", norm))


def adapt_cfg(ceps: int = 12, norm=None) -> str:
    """`vtln_cfg` followed by `mllr`, an identity lin_transform that a
    feature-space CMLLR block replaces per speaker: a configuration on
    which `recognize --adapt` runs every mode."""
    return (vtln_cfg(ceps, norm)
            + _module("mllr", "lin_transform",
                      "out" if norm is None else "norm", dim=3 * (ceps + 1)))


def _spkc_block(kind: str, ident: str, modules: dict) -> str:
    out = [f"{kind} {ident}", "{"]
    for name, items in modules.items():
        out += [f"  {name}", "  {"]
        out += [f"    {k} {v}" for k, v in items.items()]
        out.append("  }")
    return "\n".join(out + ["}", ""])


def speaker_spkc(speakers, kind: str, dim: int = 0, seed: int = 0) -> str:
    """A .spkc text with one block per speaker: ``kind`` "lin_transform"
    gives each a `cmllr` transform near the identity (`splice_cfg`),
    "vtln" a `vtln` warp factor from 0.9, 1.0, 1.1 in turn; plus an
    empty default utterance block."""
    rng = np.random.default_rng(seed)
    text = ""
    for i, spk in enumerate(speakers):
        if kind == "lin_transform":
            mat = np.eye(dim) + 0.05 * rng.normal(0, 1, (dim, dim))
            mods = {"cmllr": {"matrix": _floats(mat),
                              "bias": _floats(rng.normal(0, 0.1, dim))}}
        elif kind == "vtln":
            mods = {"vtln": {"warp_factor": (0.9, 1.0, 1.1)[i % 3]}}
        else:
            raise ValueError(f"unknown speaker block kind {kind!r}")
        text += _spkc_block("speaker", spk, mods)
    return text + _spkc_block("utterance", "default", {})


def cmllr_transforms(dim: int, classes: int, rng) -> list:
    """``classes`` CMLLR transforms near the identity, each [D, D+1]
    rows ``[b | A]`` (the form `train.mllr.apply_model_cmllr` takes)."""
    out = []
    for _ in range(classes):
        A = np.eye(dim) + 0.05 * rng.normal(0, 1, (dim, dim))
        b = rng.normal(0, 0.1, dim)
        out.append(np.concatenate([b[:, None], A], axis=1))
    return out


def model_cmllr_spkc(speakers, dim: int, num_gaussians: int,
                     classes: int = 2, seed: int = 0) -> str:
    """A .spkc text whose speakers each carry a model-namespace CMLLR
    block: ``classes`` transforms near the identity and a class per
    Gaussian; plus an empty default utterance block."""
    rng = np.random.default_rng(seed)
    text = ""
    for spk in speakers:
        items = {"classes": classes,
                 "gauss_class": " ".join(str(c) for c in rng.integers(
                     0, classes, num_gaussians))}
        for c, W in enumerate(cmllr_transforms(dim, classes, rng)):
            items[f"matrix{c}"] = _floats(W[:, 1:])
            items[f"bias{c}"] = _floats(W[:, 0])
        text += _spkc_block("speaker", spk, {"model cmllr": items})
    return text + _spkc_block("utterance", "default", {})


def feature_model(model: model_io.HmmModel, feats: np.ndarray,
                  var_scale: float, seed: int = 0) -> model_io.HmmModel:
    """``model`` with its Gaussians moved onto ``feats`` ([N, D] frames of
    the configuration it will score): means at random frames plus noise
    of 0.3 of each dimension's spread, variances ``var_scale`` times
    each dimension's variance, times 0.5 to 2.  On normalized features
    (`norm_stats`) a quarter of their variance gives peaked posteriors,
    as a trained model does: most 2-byte LNA codes saturate."""
    rng = np.random.default_rng(seed)
    G, D = model.means.shape
    feats = np.asarray(feats, dtype=np.float64)
    means = feats[rng.choice(len(feats), G, replace=len(feats) < G)]
    means = means + rng.normal(0, 0.3 * feats.std(0), (G, D))
    covars = var_scale * feats.var(0) * rng.uniform(0.5, 2.0, (G, D))
    return dataclasses.replace(model, means=means, covars=covars)


def exact_lna_codes(model: model_io.HmmModel, feats,
                    chunk: int = 256) -> np.ndarray:
    """[T, S] 2-byte LNA codes of features [T, D] under ``model`` in
    float64, straight from its means and covariances (a full covariance
    where ``model.full_covars`` has one, else the diagonal) in the
    centred form ``-(x - mu)' P (x - mu) / 2 + C``: no scorer table and
    no expanded square, so the reference against which float32 scoring
    is measured.  Full covariances must be positive definite."""
    from aaltoasr_tpu_torch.ops.gmm import lna_normalize, quantize_lna_u16
    from aaltoasr_tpu_torch.ops.logsemiring import logsumexp
    x = torch.as_tensor(np.asarray(feats, dtype=np.float64))
    G, D = model.means.shape
    prec = model.precisions()
    means = torch.as_tensor(np.asarray(model.means, dtype=np.float64))
    gll = torch.empty((x.shape[0], G), dtype=torch.float64)
    for g0 in range(0, G, chunk):
        gs = range(g0, min(G, g0 + chunk))
        d = x[:, None, :] - means[g0:gs.stop]               # [T, n, D]
        if any(g in model.full_covars for g in gs):
            # P = L L': (x - mu)' P (x - mu) = |L' (x - mu)|^2
            L = np.zeros((len(gs), D, D))
            C = np.zeros(len(gs))
            for i, g in enumerate(gs):
                P = (np.linalg.inv(np.asarray(model.full_covars[g],
                                              np.float64))
                     if g in model.full_covars else np.diag(prec[g]))
                L[i] = np.linalg.cholesky(P)
                C[i] = 0.5 * np.linalg.slogdet(P)[1]
            y = torch.einsum("tnd,nde->tne", d, torch.as_tensor(L))
        else:
            p = prec[g0:gs.stop]
            y = d * torch.as_tensor(np.sqrt(p))
            C = 0.5 * np.log(p).sum(axis=1)
        gll[:, g0:gs.stop] = torch.as_tensor(C) - 0.5 * (y * y).sum(-1)
    S = len(model.mixtures)
    ll = torch.empty((x.shape[0], S), dtype=torch.float64)
    for s, (idx, w) in enumerate(model.mixtures):
        w = np.asarray(w, np.float64)
        live = w > 0
        ll[:, s] = logsumexp(gll[:, np.asarray(idx)[live]]
                             + torch.as_tensor(np.log(w[live])), dim=-1)
    return quantize_lna_u16(lna_normalize(ll)).numpy().astype(np.int64)


def nearest_clusters(means: np.ndarray, num_clusters: int,
                     seed: int = 0) -> np.ndarray:
    """[G] cluster per Gaussian: the nearest (Euclidean) of
    ``num_clusters`` Gaussians drawn as centers (a `.gcl` clustering
    without the k-means iterations of `gcluster`)."""
    rng = np.random.default_rng(seed)
    centers = means[rng.choice(len(means), num_clusters, replace=False)]
    d2 = ((means ** 2).sum(1)[:, None] - 2.0 * means @ centers.T
          + (centers ** 2).sum(1)[None, :])
    return np.argmin(d2, axis=1).astype(np.int32)


def probe_frames(kinds, T: int, W: int, rate: int, seed: int) -> np.ndarray:
    """[T, W] float32 frames, row i of kind kinds[i % len(kinds)]: "loud"
    noise (sd 8000), "quiet" noise (sd 2), or a 1234.5 Hz "tone" of
    amplitude 5000 with a random phase, between DFT bins so that every
    bin holds leakage and none only cancellation residue."""
    rng = np.random.default_rng(seed)
    n = np.arange(W)
    rows = []
    for i in range(T):
        kind = kinds[i % len(kinds)]
        if kind == "loud":
            rows.append(rng.normal(0, 8000, W))
        elif kind == "quiet":
            rows.append(rng.normal(0, 2, W))
        elif kind == "tone":
            phase = rng.uniform(0, 2 * np.pi)
            rows.append(5000 * np.sin(2 * np.pi * 1234.5 / rate * n + phase))
        else:
            raise ValueError(f"unknown frame kind {kind!r}")
    return np.stack(rows).astype(np.float32)


def random_model(G=512, S=128, D=39, K=8, seed=0) -> model_io.HmmModel:
    """Random diagonal GMM with K components per tied state (the bench's
    scoring model at G=10,000, S=2,500, K=8)."""
    rng = np.random.default_rng(seed)
    mixtures = [(rng.choice(G, K, replace=False).astype(np.int32),
                 rng.dirichlet(np.ones(K))) for _ in range(S)]
    phones = []
    transitions = {}
    for i in range(S // 2):
        s0, s1 = 2 * i, 2 * i + 1
        phones.append(model_io.HmmPhone(label=f"p{i}", states=[s0, s1]))
        transitions[s0] = [(0, 0.7), (1, 0.3)]
        transitions[s1] = [(0, 0.6), (1, 0.4)]
    return model_io.HmmModel(
        dim=D, cov_type="diagonal_cov",
        means=rng.normal(0, 2, (G, D)), covars=rng.uniform(0.3, 3, (G, D)),
        mixtures=mixtures, phones=phones, transitions=transitions)


def uneven_model(G=60, S=21, D=39, K=5, seed=0) -> model_io.HmmModel:
    """Random diagonal GMM whose states have 1 to K components (state s
    has 1 + s % K), and every seventh state a zero weight on its first
    component: the slot tables then hold LOG_ZERO slots inside the real
    states, first slots among them."""
    rng = np.random.default_rng(seed)
    mixtures = []
    for s in range(S):
        n = 1 + s % K
        w = rng.dirichlet(np.ones(n))
        if s % 7 == 3 and n > 1:
            w[0] = 0.0
            w /= w.sum()
        mixtures.append((rng.choice(G, n, replace=False).astype(np.int32), w))
    model = random_model(G=G, S=S, D=D, K=1, seed=seed)
    model.mixtures = mixtures
    return model


@dataclass
class SynthTask:
    model: model_io.HmmModel
    tree: PrefixTree
    fsa: NGramFsa
    arpa: ArpaLM
    lex_lines: list
    info: dict          # prons, words, phones, triphone, follow


def synth_task(num_words=1000, num_phones=25, seed=0, order=2,
               triphone=False, durations=False,
               tied_variants=6) -> SynthTask:
    """Synthetic decode task shaped like the reference's operating point.

    triphone=True builds a decision-tree-tied cross-word triphone
    inventory (every ``l-c+r`` the lexicon's cross-word expansion asks
    for, 3 states drawn from a pool keyed by (center, position,
    left-class, right-class)), so the cross-word tree builder runs;
    durations=True attaches per-state gamma duration parameters.
    """
    rng = np.random.default_rng(seed)
    phones = [f"p{i}" for i in range(num_phones)] + ["_"]
    D = 39

    # triphone task: 1-state '_' (the optional short silence) plus a
    # 3-state long silence '__'; the monophone task keeps one 3-state '_'
    lex_lines = ["_ _", "__ __"] if triphone else ["_ _"]
    words = []
    prons = []
    for w in range(num_words):
        n = int(rng.integers(3, 9))
        pron = [phones[int(rng.integers(num_phones))] for _ in range(n)]
        prons.append(pron)
        words.append(f"w{w}")
        lex_lines.append(f"w{w} " + " ".join(pron))

    if triphone:
        def cls(p, salt):
            return zlib.crc32(f"{p}|{salt}".encode()) % tied_variants

        state_key: dict = {}

        def tied_state(c, pos, l, r):
            k = (c, pos, cls(l, 0), cls(r, 1))
            if k not in state_key:
                state_key[k] = len(state_key)
            return state_key[k]

        labels: dict = {}

        def add_tri(l, c, r):
            lbl = f"{l}-{c}+{r}"
            if lbl not in labels:
                labels[lbl] = [tied_state(c, pos, l, r) for pos in range(3)]

        classes = sorted({p[0] for p in prons}
                         | {p[-1] for p in prons} | {"_"})
        for p in prons:
            for i in range(1, len(p) - 1):
                add_tri(p[i - 1], p[i], p[i + 1])
            for c in classes:              # cross-word fan-in/fan-out
                add_tri(c, p[0], p[1])
                add_tri(p[-2], p[-1], c)
        sil0 = len(state_key)
        S = sil0 + 4
        model_phones = (
            [model_io.HmmPhone(lbl, sts) for lbl, sts in labels.items()]
            + [model_io.HmmPhone("_", [sil0]),
               model_io.HmmPhone("__", [sil0 + 1, sil0 + 2, sil0 + 3])])
        means = rng.normal(0, 2, (S, D))
        model = model_io.HmmModel(
            dim=D, cov_type="diagonal_cov", means=means,
            covars=np.ones((S, D)),
            mixtures=[(np.array([i], np.int32), np.array([1.0]))
                      for i in range(S)],
            phones=model_phones,
            transitions={i: [(0, 0.5), (1, 0.5)] for i in range(S)})
    else:
        S = 3 * len(phones)
        means = rng.normal(0, 2, (S, D))
        model = model_io.HmmModel(
            dim=D, cov_type="diagonal_cov", means=means,
            covars=np.ones((S, D)),
            mixtures=[(np.array([i], np.int32), np.array([1.0]))
                      for i in range(S)],
            phones=[model_io.HmmPhone(p, [3 * i, 3 * i + 1, 3 * i + 2])
                    for i, p in enumerate(phones)],
            transitions={i: [(0, 0.5), (1, 0.5)] for i in range(S)})
    if durations:
        # gamma (a, b) per state, the dur_est.cc model family
        model.durations = np.stack(
            [rng.uniform(1.5, 4.0, S), rng.uniform(1.5, 4.0, S)], axis=1)

    vocab = ["<s>", "</s>"] + words
    word_index = {w: i for i, w in enumerate(vocab)}
    uni = {(word_index[v],): (float(np.log(1.0 / len(vocab))), -0.7)
           for v in vocab}
    bi = {}
    for _ in range(num_words * 10):
        a = word_index[words[int(rng.integers(num_words))]]
        b = word_index[words[int(rng.integers(num_words))]]
        bo = -0.5 if order > 2 else 0.0
        bi[(a, b)] = (float(np.log(0.01 + rng.random() * 0.05)), bo)
    grams = [{}, uni, bi]
    if order >= 3:
        tri = {}
        bikeys = list(bi)
        for _ in range(num_words * 20):
            a, b = bikeys[int(rng.integers(len(bikeys)))]
            c = word_index[words[int(rng.integers(num_words))]]
            tri[(a, b, c)] = (float(np.log(0.02 + rng.random() * 0.1)), 0.0)
        grams.append(tri)
    arpa = ArpaLM(order=order, vocab=vocab, word_index=word_index,
                  ngrams=grams)
    tree = build_prefix_tree(model, read_lexicon("\n".join(lex_lines)),
                             optional_short_silence=triphone)
    # bigram successor lists (indices into `words`): planted sequences
    # follow the LM's own bigrams, so the true path is LM-plausible
    follow: dict = {}
    for (a, b) in bi:
        if a >= 2 and b >= 2:
            follow.setdefault(a - 2, []).append(b - 2)
    info = {"prons": prons, "words": words, "phones": phones,
            "triphone": triphone, "follow": follow}
    return SynthTask(model=model, tree=tree, fsa=NGramFsa.from_arpa(arpa),
                     arpa=arpa, lex_lines=lex_lines, info=info)


def synth_obs(model, info, B, T, seed=1):
    """Planted state plan: a random LM-plausible word sequence per batch
    element (states through the model's own cross-word context
    resolution; stay lengths from the model's gamma durations, else 2-5
    frames per state).  Returns ([B, T] int32 state plan, true word id
    sequences); `planted_obs` turns the plan into log-probs."""
    rng = np.random.default_rng(seed)
    phone_map = {p.label: p for p in model.phones}
    prons, words = info["prons"], info["words"]
    follow = info.get("follow", {})
    plan = np.zeros((B, T), np.int32)
    true_words = []
    for b in range(B):
        t = 0
        seq = []
        prev_last = "_"

        def next_word(prev):
            nx = follow.get(prev)
            if nx:
                return int(nx[int(rng.integers(len(nx)))])
            return int(rng.integers(len(words)))

        w = next_word(-1)
        while t < T:
            p = prons[w]
            w_next = next_word(w)
            nxt = prons[w_next][0]
            states = []
            for j, c in enumerate(p):
                l = p[j - 1] if j > 0 else prev_last
                r = p[j + 1] if j + 1 < len(p) else nxt
                if info["triphone"]:
                    lbl = _resolve_context(phone_map, l, c, r) or c
                else:
                    lbl = c
                states.extend(phone_map[lbl].states)
            for s in states:
                if getattr(model, "durations", None) is not None:
                    a, bb = model.durations[s]
                    d = int(np.clip(round(rng.gamma(a, bb)), 1, 12))
                else:
                    d = int(rng.integers(2, 6))
                plan[b, t:t + d] = s
                t += d
                if t >= T:
                    break
            if t < T:          # word fully planted
                seq.append(w)
            prev_last = p[-1]
            w = w_next
        true_words.append(seq)
    return plan, true_words


def planted_obs(plan, num_states: int, generator: torch.Generator,
                device: torch.device | str = "cpu", gain: float = 8.0,
                noise: float = 2.0) -> torch.Tensor:
    """[B, T] plan -> [B, T, S] observations: N(-5, noise^2) everywhere
    plus ``gain`` on the planted state, drawn on ``device``."""
    plan_t = torch.as_tensor(plan, dtype=torch.int64, device=device)
    z = torch.randn(plan_t.shape + (num_states,), generator=generator,
                    device=device) * noise - 5.0
    return z.scatter_add_(-1, plan_t[..., None],
                          torch.full(plan_t.shape + (1,), gain,
                                     device=device))


def speaker_wave(rng, scale: float, n: int, rate: int = 16000,
                 noise: float = 150.0) -> np.ndarray:
    """[n] samples of one synthetic speaker: partials at 500, 1,400 and
    2,600 Hz times ``scale`` (a spectrally scaled speaker, as a shorter
    vocal tract gives), each swelling and fading at its own slow rate,
    plus N(0, noise^2)."""
    t = np.arange(n) / rate
    sig = sum(a * (1.0 + 0.6 * np.sin(2 * np.pi * m * t + ph))
              * np.sin(2 * np.pi * f * scale * t)
              for a, f, m, ph in ((2500, 500, 0.7, 0.0), (1500, 1400, 1.3, 1.0),
                                  (800, 2600, 2.1, 2.0)))
    return np.clip(sig + noise * rng.standard_normal(n), -32000, 32000)


def write_wav(path, samples: np.ndarray, rate: int = 16000) -> None:
    """Mono 16-bit PCM WAV."""
    pcm = np.clip(np.round(samples), -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def write_task(task: SynthTask, out_dir, num_wavs: int = 4,
               seconds: float = 8.0, seed: int = 2) -> dict:
    """Write a task as files: model (am.ph/.gk/.mc[/.dur]), feats.cfg,
    lex.txt, lm.arpa, `num_wavs` WAVs of N(0, 1000^2) samples at 16 kHz
    and a recipe naming each WAV and its LNA.  Returns the paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = {k: os.path.join(out_dir, v) for k, v in (
        ("am", "am"), ("cfg", "feats.cfg"), ("lexicon", "lex.txt"),
        ("lm", "lm.arpa"), ("recipe", "task.recipe"), ("lna", "lna"))}
    model_io.write_model(paths["am"], task.model)
    with open(paths["cfg"], "w") as f:
        f.write(MFCC_CFG)
    with open(paths["lexicon"], "w") as f:
        f.write("\n".join(task.lex_lines) + "\n")
    write_arpa(task.arpa, paths["lm"])
    os.makedirs(paths["lna"], exist_ok=True)
    rng = np.random.default_rng(seed)
    n = int(16000 * seconds)
    lines = []
    for u in range(num_wavs):
        wav = os.path.join(out_dir, f"u{u}.wav")
        write_wav(wav, rng.normal(0, 1000, n))
        lna = os.path.join(paths["lna"], f"u{u}.lna")
        lines.append(f"audio={wav} lna={lna} utterance=u{u}")
    with open(paths["recipe"], "w") as f:
        f.write("\n".join(lines) + "\n")
    return paths
