"""lda: LDA transform estimation -> lin_transform module (`aku/lda.cc`).

Counterpart of `aaltoasr_tpu/cli/lda.py`, with the same flags plus
``--device`` for the frontend (default ``cuda``; with no GPU it raises
unless ``--device cpu`` is given).  Accumulates per-tied-state full
statistics of the lda module's SOURCE features (lda.cc:103-110 reads
``source_module->at(f)``, i.e. the features flowing INTO the transform),
selects states by gamma (``--mingamma``, top ``maxmem``-bounded states,
optional ``--no-silence``), solves the whitened discriminant transform
(`train/lda.py`, host float64) and writes it into the named
lin_transform module of the output configuration (lda.cc:376-466).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from aaltoasr_tpu_torch.device import resolve_device
from aaltoasr_tpu_torch.formats.feaconf import FeatureConfig
from aaltoasr_tpu_torch.formats.model_io import read_model
from aaltoasr_tpu_torch.formats.phn import read_phn
from aaltoasr_tpu_torch.formats.recipe import Recipe
from aaltoasr_tpu_torch.frontend.audio import read_audio
from aaltoasr_tpu_torch.frontend.generator import FeatureGenerator
from aaltoasr_tpu_torch.train.lda import LdaAccumulator


def source_generator(cfg: FeatureConfig, module: str,
                     device) -> FeatureGenerator:
    """Generator evaluating the named module's source output: the
    config truncated at the source module (valid for the topologically
    ordered module chains `FeatureConfig.parse` produces)."""
    spec = cfg.by_name[module]
    (src,) = spec.sources
    idx = next(i for i, m in enumerate(cfg.modules) if m.name == src)
    return FeatureGenerator(FeatureConfig(list(cfg.modules[:idx + 1])),
                            device=device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="lda")
    p.add_argument("-p", "--ph", "-b", "--base", dest="base",
                   required=True, help="HMM definitions (model base)")
    p.add_argument("-c", "--config", required=True,
                   help="feature configuration (with the transform module)")
    p.add_argument("-r", "--recipe", required=True)
    p.add_argument("-w", "--write-config", "-o", "--out", dest="out",
                   required=True, help="output feature configuration")
    p.add_argument("-M", "--module", default="lda",
                   help="lin_transform module to fill")
    p.add_argument("-d", "--dim", type=int, required=True,
                   help="output dimension")
    p.add_argument("-O", "--ophn", action="store_true")
    p.add_argument("--mingamma", type=float, default=50.0,
                   help="minimum gamma value per state (lda.cc default 50)")
    p.add_argument("--maxgamma", type=float, default=1e6,
                   help="gamma ceiling in the scatter weights")
    p.add_argument("-m", "--maxmem", type=int, default=3000,
                   help="memory bound in MB -> max states (lda.cc:115-117)")
    p.add_argument("--no-silence", action="store_true",
                   help="exclude '_'/'__' states from estimation")
    p.add_argument("-i", "--info", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a GPU "
                        "unless cpu is given)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    model = read_model(args.base)
    cfg = FeatureConfig.load(args.config)
    fg = source_generator(cfg, args.module, device)
    label_states = {ph.label: ph.states for ph in model.phones}
    acc = LdaAccumulator(model.num_states, fg.dim)
    spf = 16000.0 / fg.frame_rate

    recipe = Recipe.read(args.recipe)
    for rinfo in recipe:
        path = rinfo.alignment_path if args.ophn else rinfo.transcript_path
        if args.info > 0:
            print(f"Processing file: {rinfo.audio_path}", file=sys.stderr)
        samples, _ = read_audio(rinfo.audio_path, fg.sample_rate)
        feats = fg.features(samples).cpu().numpy()
        T = feats.shape[0]
        for e in read_phn(path):
            if e.start < 0 or e.label not in label_states:
                continue
            sts = label_states[e.label]
            state = sts[e.state] if 0 <= e.state < len(sts) else sts[0]
            sf, ef = e.frame_span(spf)
            if ef > sf:
                # frames past feature eof accumulate the border-clamped
                # last frame: lda.cc:343-356 reads source_module->at(frame),
                # which serves border frames without tripping
                # fea_gen.eof() (unlike stats.cc's top-level generate(),
                # which truncates)
                idx = np.minimum(np.arange(sf, ef), T - 1)
                acc.add(state, feats[idx])

    exclude = []
    if args.no_silence:
        for sil in ("_", "__"):
            exclude.extend(label_states.get(sil, ()))
    max_classes = min(
        int(args.maxmem * 1e6 / (fg.dim * fg.dim * 8)), model.num_states)
    W = acc.solve(args.dim, min_gamma=args.mingamma,
                  max_gamma=args.maxgamma, max_classes=max_classes,
                  exclude=tuple(exclude))
    spec = cfg.by_name[args.module]
    spec.config.set("dim", args.dim)
    spec.config.set("matrix", [float(x) for x in W.reshape(-1)])
    cfg.save(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
