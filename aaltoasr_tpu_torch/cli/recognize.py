"""recognize: the batch recognition driver (pyrectool equivalent).

Counterpart of `aaltoasr_tpu/cli/recognize.py`, with the same flags and
rectool's reuse semantics (rectool.py:613-634, 1045-1056): LNA
generation through the scoring pipeline (skip-if-exists), then decoding
through `Toolbox` with 1-best output, and on request SLF lattices
(``<lna>.slf``), n-best lists and confusion-network confidences: the
exact engine one utterance at a time, or the dense engine in batches;
``--engine auto`` (the default) picks exact below 100k tree nodes.  It
runs on ``--device`` (default ``cuda``; with no GPU it raises unless
``--device cpu`` is given).  Adaptation and state segmentations are not
ported yet and raise NotImplementedError naming the ROADMAP item that
brings them.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from aaltoasr_tpu_torch.decoder.search_dense import DenseBeamSearch
from aaltoasr_tpu_torch.decoder.toolbox import Toolbox
from aaltoasr_tpu_torch.decoder.wordgraph import confusion_network
from aaltoasr_tpu_torch.device import resolve_device
from aaltoasr_tpu_torch.formats.lna import read_lna
from aaltoasr_tpu_torch.formats.recipe import Recipe
from aaltoasr_tpu_torch.models.phone_probs import PhoneProbs

# --engine auto split point of the reference (exact below, dense above)
AUTO_ENGINE_NODE_THRESHOLD = 100_000

_LATER = {
    "adapt": "adaptation is not ported yet (ROADMAP queue 1 item 6: "
             "adaptation)",
    "stateseg": "state segmentation is not ported yet (ROADMAP queue 1 "
                "item 5: training, its hmmnet half, whose HMM networks it "
                "aligns on)",
}


def select_engine(n_nodes: int) -> str:
    """Scale-based engine choice for --engine auto."""
    return "dense" if n_nodes >= AUTO_ENGINE_NODE_THRESHOLD else "exact"


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
                   help="decoder engine: exact token passing, the dense "
                        "batched mode (node-level Viterbi recombination), "
                        "or auto (exact below "
                        f"{AUTO_ENGINE_NODE_THRESHOLD} tree nodes, dense "
                        "above)")
    p.add_argument("--decode-batch", type=int, default=32,
                   help="utterances decoded together (dense engine)")
    p.add_argument("--overflow-tokens", type=int, default=0,
                   help="exact engine: branch-expansion budget (0 = "
                        "every arc of every token)")
    p.add_argument("--lattices", action="store_true",
                   help="write SLF word graphs next to the LNAs")
    p.add_argument("--nbest", type=int, default=0,
                   help="print n-best lists")
    p.add_argument("--stateseg", action="store_true",
                   help="write state segmentations (not ported)")
    p.add_argument("--confidence", action="store_true",
                   help="print per-word confusion-network confidences")
    p.add_argument("--we-prewalk", type=int, default=0,
                   help="exact engine: LM-walk only the top-N word ends "
                        "ranked by a static unigram estimate (0 = all)")
    p.add_argument("--word-end-beam", type=float, default=0.0,
                   help="prune word ends vs the frame's best word end "
                        "(Toolbox.hh:205); 0 = off")
    p.add_argument("--reentry-records", type=int, default=0,
                   help="exact engine: only the top-N record slots "
                        "re-enter (all are written); 0 = all")
    p.add_argument("--reentry-prewalk", type=int, default=0,
                   help="exact engine: each re-entering record keeps its "
                        "top-N cross-word entry nodes; 0 = all")
    p.add_argument("--lookahead", type=int, default=0,
                   help="LM lookahead: 0 off, 1 unigram table, 2 bigram "
                        "table, 3 context (>= trigram)")
    p.add_argument("--lookahead-ngram", default=None,
                   help="separate (smaller) ARPA for lookahead scores")
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
    if args.stateseg:
        raise NotImplementedError(_LATER["stateseg"])

    device = resolve_device(args.device)
    os.makedirs(args.workdir, exist_ok=True)
    recipe = Recipe.read(args.recipe, args.batch, args.bindex)

    # -- the decoder first, so that an unported knob raises before any
    # LNA is written
    t = Toolbox(args.am + ".ph", args.dur, device=device)
    # morph LM (rectool.py:529-530, 563-564): silences become words and
    # the short silence commits '<w>'
    morph_lm = is_morph_lm(args.lm)
    if morph_lm:
        if args.info > 0:
            print("Morph-based language model", file=sys.stderr)
        t.set_silence_is_word(True)
        t.set_word_boundary("<w>")
    # the reference's trees default the optional short silence on
    # (TPLexPrefixTree.cc:54), and rectool always requires the sentence
    # end (rectool.py:537)
    t.set_optional_short_silence(not args.no_oss)
    t.set_require_sentence_end(not args.no_require_end)
    t.lex_read(args.lexicon)
    t.ngram_read(args.lm)
    t.set_global_beam(args.beam)
    t.set_token_limit(args.tokens)
    t.set_lm_scale(args.lm_scale)
    t.set_duration_scale(args.duration_scale)
    t.set_insertion_penalty(args.insertion_penalty)
    t.set_overflow_tokens(args.overflow_tokens)
    t.set_split_multiwords(args.split_multiwords)
    t.set_we_prewalk(args.we_prewalk)
    t.set_word_end_beam(args.word_end_beam)
    t.set_reentry_records(args.reentry_records)
    t.set_reentry_prewalk(args.reentry_prewalk)
    t.set_lm_lookahead(args.lookahead)
    if args.lookahead_ngram:
        t.read_lookahead_ngram(args.lookahead_ngram)
    engine = args.engine
    if engine == "auto":
        engine = select_engine(t.tree.num_nodes)
        if args.info >= 0:
            print(f"engine auto: {t.tree.num_nodes} tree nodes -> {engine}",
                  file=sys.stderr)

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

    need_lattice = bool(args.lattices or args.nbest or args.confidence)

    def emit(rinfo, lna_path, res):
        key = rinfo.utterance_id or os.path.basename(lna_path)
        text = " ".join(res.words)
        if morph_lm:
            # rectool.py:1025-1037: morphs concatenate; boundaries and
            # sentence breaks become spaces
            text = text.replace(" ", "")
            text = text.replace("<w></s><s><w>", " ")
            text = text.replace("<w>", " ")
            text = text.replace("<s>", "").replace("</s>", "")
            text = " ".join(text.split())
        print(f"{text} ({key})")
        if need_lattice:
            g = res.word_graph()
            if args.lattices:
                g.write_slf(lna_path + ".slf")
            if args.nbest > 0:
                for i, (words, score) in enumerate(g.nbest(args.nbest)):
                    print(f"  {i + 1}: {' '.join(words)} ({score:.3f})")
            if args.confidence:
                conf = " ".join(f"{w}({c:.2f})"
                                for w, c, _ in confusion_network(g))
                print(f"  conf: {conf}")

    items = list(zip(recipe, lna_paths))
    if engine == "exact":
        for rinfo, path in items:
            emit(rinfo, path, t.lna_decode(path, lattice=need_lattice))
        return 0

    # the dense engine: utterances padded to a shared frame count and
    # decoded together
    search = DenseBeamSearch(t.tree, t.lm, t.model, t.config, device=device)
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
        results = search.decode_batch(obs, n, lattice=need_lattice)
        for (rinfo, path), res in zip(group, results):
            emit(rinfo, path, res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
