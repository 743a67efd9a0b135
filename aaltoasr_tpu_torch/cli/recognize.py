"""recognize: the batch recognition driver (pyrectool equivalent).

Counterpart of `aaltoasr_tpu/cli/recognize.py`, with the same flags and
rectool's reuse semantics (rectool.py:613-634, 1045-1056): LNA
generation through the scoring pipeline (skip-if-exists), then batched
decoding with the dense engine and 1-best output.  It runs on
``--device`` (default ``cuda``; with no GPU it raises unless ``--device
cpu`` is given).  The exact engine (and ``--engine
auto``, which picks it below 100k tree nodes), adaptation, lattices,
n-best lists, confidences and state segmentations are not ported yet
and raise NotImplementedError naming the slice that brings them.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from aaltoasr_tpu_torch.decoder.lexicon import build_prefix_tree, read_lexicon
from aaltoasr_tpu_torch.decoder.ngram import NGramFsa
from aaltoasr_tpu_torch.decoder.search import SearchConfig
from aaltoasr_tpu_torch.decoder.search_dense import DenseBeamSearch
from aaltoasr_tpu_torch.device import resolve_device
from aaltoasr_tpu_torch.formats.arpa import read_arpa
from aaltoasr_tpu_torch.formats.lna import read_lna
from aaltoasr_tpu_torch.formats.model_io import HmmModel, read_dur, read_ph
from aaltoasr_tpu_torch.formats.recipe import Recipe
from aaltoasr_tpu_torch.models.phone_probs import PhoneProbs

# --engine auto split point of the reference (exact below, dense above)
AUTO_ENGINE_NODE_THRESHOLD = 100_000

_LATER = {
    "exact": "the exact engine is not ported yet (ROADMAP queue 1, "
             "slice 2: exact engine and streaming)",
    "adapt": "adaptation is not ported yet (ROADMAP queue 1, slice 4)",
    "lattice": "lattices, n-best lists and confidences are not ported "
               "yet (ROADMAP queue 1: lattices and wordgraph)",
    "stateseg": "state segmentation is not ported yet (ROADMAP queue 1, "
                "slice 2: Toolbox and stateseg)",
}


def select_engine(n_nodes: int) -> str:
    """Scale-based engine choice for --engine auto."""
    return "dense" if n_nodes >= AUTO_ENGINE_NODE_THRESHOLD else "exact"


def decoder_model(ph_path: str, dur_path: str = "") -> HmmModel:
    """Topology + durations only: acoustics arrive as LNA log-probs
    (the reference Toolbox's model)."""
    phones, transitions = read_ph(ph_path)
    num_states = 1 + max((s for p in phones for s in p.states), default=0)
    model = HmmModel(
        dim=0, cov_type="diagonal_cov",
        means=np.zeros((0, 1)), covars=np.zeros((0, 1)),
        mixtures=[(np.zeros(0, np.int32), np.zeros(0))] * num_states,
        phones=phones, transitions=transitions)
    if dur_path:
        model.durations = read_dur(dur_path)
    return model


def is_morph_lm(path: str) -> bool:
    """An LM whose unigrams contain '<w>' is a morph LM
    (rectool.py:432-496 parse_lm)."""
    with open(path) as f:
        in1 = False
        for line in f:
            line = line.strip()
            if line == "\\1-grams:":
                in1 = True
                continue
            if in1:
                if line.startswith("\\"):
                    return False
                parts = line.split()
                if len(parts) >= 2 and parts[1] == "<w>":
                    return True
    return False


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="recognize")
    p.add_argument("-b", "--am", required=True,
                   help="acoustic model base name")
    p.add_argument("-c", "--config", required=True,
                   help="feature configuration")
    p.add_argument("-l", "--lexicon", required=True)
    p.add_argument("-n", "--lm", required=True, help="ARPA language model")
    p.add_argument("-r", "--recipe", required=True)
    p.add_argument("-w", "--workdir", required=True)
    p.add_argument("--dur", default="", help="duration file")
    p.add_argument("--beam", type=float, default=280.0)
    p.add_argument("--tokens", type=int, default=1024)
    p.add_argument("--lm-scale", type=float, default=30.0)
    p.add_argument("--duration-scale", type=float, default=3.0)
    p.add_argument("--insertion-penalty", type=float, default=0.0)
    p.add_argument("--adapt",
                   choices=["", "vtln", "mllr", "cmllr", "vtln+mllr"],
                   default="", help="per-speaker adaptation (not ported)")
    p.add_argument("--engine", choices=["auto", "exact", "dense"],
                   default="auto",
                   help="decoder engine; only the dense batched engine "
                        "is ported, auto picks exact below "
                        f"{AUTO_ENGINE_NODE_THRESHOLD} tree nodes")
    p.add_argument("--decode-batch", type=int, default=32,
                   help="utterances decoded together (dense engine)")
    p.add_argument("--overflow-tokens", type=int, default=0,
                   help="exact engine only")
    p.add_argument("--lattices", action="store_true",
                   help="write SLF word graphs (not ported)")
    p.add_argument("--nbest", type=int, default=0,
                   help="print n-best lists (not ported)")
    p.add_argument("--stateseg", action="store_true",
                   help="write state segmentations (not ported)")
    p.add_argument("--confidence", action="store_true",
                   help="print confidences (not ported)")
    p.add_argument("--we-prewalk", type=int, default=0,
                   help="exact engine only")
    p.add_argument("--word-end-beam", type=float, default=0.0,
                   help="exact engine only")
    p.add_argument("--reentry-records", type=int, default=0,
                   help="exact engine only")
    p.add_argument("--reentry-prewalk", type=int, default=0,
                   help="exact engine only")
    p.add_argument("--lookahead", type=int, default=0,
                   help="LM lookahead (exact engine only)")
    p.add_argument("--lookahead-ngram", default=None,
                   help="separate ARPA for lookahead (exact engine only)")
    p.add_argument("--split-multiwords", action="store_true",
                   help="score multiwords (give_me) as component-word "
                        "sequences in the LM (Toolbox.hh:223-232)")
    p.add_argument("--no-require-end", action="store_true",
                   help="do not add P(</s>|h) when ranking final "
                        "hypotheses (rectool.py:537 always requires it)")
    p.add_argument("--no-oss", action="store_true",
                   help="disable the optional short silence between "
                        "words (the reference defaults it on, "
                        "TPLexPrefixTree.cc:54)")
    p.add_argument("-B", "--batch", type=int, default=0)
    p.add_argument("-I", "--bindex", type=int, default=0)
    p.add_argument("-i", "--info", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a GPU "
                        "unless cpu is given)")
    args = p.parse_args(argv)

    if args.adapt:
        raise NotImplementedError(_LATER["adapt"])
    if args.lattices or args.nbest or args.confidence:
        raise NotImplementedError(_LATER["lattice"])
    if args.stateseg:
        raise NotImplementedError(_LATER["stateseg"])
    if args.engine == "exact":
        raise NotImplementedError(_LATER["exact"])

    device = resolve_device(args.device)
    os.makedirs(args.workdir, exist_ok=True)
    recipe = Recipe.read(args.recipe, args.batch, args.bindex)

    # -- LNA generation (skip-if-exists, rectool.py:613-634)
    lna_dir = os.path.join(args.workdir, "lna")
    os.makedirs(lna_dir, exist_ok=True)
    lna_paths = []
    pp = None
    for rinfo in recipe:
        name = rinfo.lna_path or os.path.basename(rinfo.audio_path) + ".lna"
        path = os.path.join(lna_dir, os.path.basename(name))
        lna_paths.append(path)
        if os.path.exists(path):
            continue
        if pp is None:
            pp = PhoneProbs(args.am, args.config, lna_bytes=2, device=device)
        if args.info > 0:
            print(f"LNA: {rinfo.audio_path}", file=sys.stderr)
        pp.generate_to_file(rinfo.audio_path, path)

    # -- decoding
    model = decoder_model(args.am + ".ph", args.dur)
    cfg = SearchConfig(beam=args.beam, num_tokens=args.tokens,
                       lm_scale=args.lm_scale,
                       duration_scale=args.duration_scale,
                       insertion_penalty=args.insertion_penalty,
                       split_multiwords=args.split_multiwords,
                       require_sentence_end=not args.no_require_end)
    # morph LM (rectool.py:529-530, 563-564): silences become words and
    # the short silence commits '<w>'
    morph_lm = is_morph_lm(args.lm)
    if morph_lm:
        if args.info > 0:
            print("Morph-based language model", file=sys.stderr)
        cfg.word_boundary = "<w>"
    tree = build_prefix_tree(
        model, read_lexicon(args.lexicon), silence_is_word=True,
        optional_short_silence=not args.no_oss,
        word_boundary=cfg.word_boundary)
    lm = NGramFsa.from_arpa(read_arpa(args.lm))

    if args.engine == "auto":
        engine = select_engine(tree.num_nodes)
        if args.info >= 0:
            print(f"engine auto: {tree.num_nodes} tree nodes -> {engine}",
                  file=sys.stderr)
        if engine == "exact":
            raise NotImplementedError(
                _LATER["exact"] + "; pass --engine dense")

    search = DenseBeamSearch(tree, lm, model, cfg, device=device)
    items = list(zip(recipe, lna_paths))
    for lo in range(0, len(items), args.decode_batch):
        group = items[lo:lo + args.decode_batch]
        obs_list = [read_lna(path)[0] for _, path in group]
        S = obs_list[0].shape[1]
        T = max(o.shape[0] for o in obs_list)
        obs = np.zeros((len(group), T, S), np.float32)
        n = np.zeros(len(group), np.int64)
        for i, o in enumerate(obs_list):
            obs[i, :o.shape[0]] = o
            n[i] = o.shape[0]
        for (rinfo, path), res in zip(group, search.decode_batch(obs, n)):
            key = rinfo.utterance_id or os.path.basename(path)
            text = " ".join(res.words)
            if morph_lm:
                # rectool.py:1025-1037: morphs concatenate; boundaries
                # and sentence breaks become spaces
                text = text.replace(" ", "")
                text = text.replace("<w></s><s><w>", " ")
                text = text.replace("<w>", " ")
                text = text.replace("<s>", "").replace("</s>", "")
                text = " ".join(text.split())
            print(f"{text} ({key})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
