"""LNA code agreement of the port's kernels and scorers on the GPU, by
model variance scale.

    python3 tools/torch_lna_agreement.py

Four 8 s WAVs of N(0, 1000^2) noise go through the splice + LDA and the
VTLN configurations of `synth.py` (speaker "c"'s feature transform or
warp applied), each with the plain frontend and with the fused MFCC
core (K2).  A 2,704-state, one-Gaussian model is placed on the features
(means at frames plus noise, as `synth.feature_model`) at several
variance scales: a multiple of the features' mean variance
("meanvar"), or of each dimension's own variance ("dimvar"), on the
features as they come or normalized to zero mean and unit variance per
dimension ("norm-", as a `normalization` module would).  For each,
it prints the share of 2-byte LNA codes inside the code range (neither
0 nor 65535) and the agreement (largest step, share identical) of:

* K2 + K1 (fused frontend, fused scorer) against the plain path,
* K1 alone (plain frontend) and K2 alone (plain scorer) against it,
* on the splice configuration, the full-covariance scorer (model-space
  CMLLR, 4 classes) and the gated scorer (64 clusters, eval_ming 0.1)
  on the card against the CPU.

It needs a GPU and nvcc (the kernels build at first use); it never
imports jax.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from aaltoasr_tpu_torch.formats.feaconf import FeatureConfig  # noqa: E402
from aaltoasr_tpu_torch.formats.spkc import SpeakerConfig  # noqa: E402
from aaltoasr_tpu_torch.frontend.generator import (  # noqa: E402
    FeatureGenerator)
from aaltoasr_tpu_torch.ops.gmm import (  # noqa: E402
    GmmScorer, quantize_lna_u16)
from aaltoasr_tpu_torch.ops.gmm_cuda import FusedGmmScorer  # noqa: E402
from aaltoasr_tpu_torch.synth import (  # noqa: E402
    cmllr_transforms, nearest_clusters, random_model, speaker_spkc,
    splice_cfg, vtln_cfg)
from aaltoasr_tpu_torch.train.mllr import apply_model_cmllr  # noqa: E402

# (name, variance scale, pooled over dimensions, features normalized)
SCALES = (("meanvar16", 16.0, True, False), ("meanvar64", 64.0, True, False),
          ("dimvar1", 1.0, False, False), ("norm-dimvar0.25", 0.25, False, True),
          ("norm-dimvar0.5", 0.5, False, True), ("norm-dimvar1", 1.0, False, True),
          ("norm-dimvar2", 2.0, False, True))


def codes(scorer, feats) -> torch.Tensor:
    return torch.cat([quantize_lna_u16(scorer.lna_log_probs(x))
                      for x in feats]).cpu().long()


def agreement(a, b) -> str:
    d = (a - b).abs()
    return f"max {int(d.max())} same {float((d == 0).float().mean()):.5f}"


def in_range(c) -> float:
    return float(((c > 0) & (c < 65535)).float().mean())


def model(base, feats, scale, pooled):
    rng = np.random.default_rng(7)
    G, D = base.means.shape
    means = feats[rng.choice(len(feats), G)] + rng.normal(
        0, 0.3 * feats.std(0), (G, D))
    u = rng.uniform(0.5, 2.0, (G, D))
    var = feats.var(0).mean() if pooled else feats.var(0)
    return dataclasses.replace(base, means=means, covars=scale * var * u)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    wavs = [np.round(rng.normal(0, 1000, 128000)).astype(np.float32)
            for _ in range(4)]
    base = random_model(G=2704, S=2704, D=39, K=1, seed=3)
    for cname, text, kind in (("splice", splice_cfg(), "lin_transform"),
                              ("vtln", vtln_cfg(), "vtln")):
        spk = SpeakerConfig.parse(speaker_spkc(
            ["a", "b", "c"], kind, dim=39)).speaker_params("c")
        gens = []
        for fused_mfcc in (False, True):
            fg = FeatureGenerator(FeatureConfig.parse(text),
                                  fused_mfcc=fused_mfcc, device=dev)
            fg.apply_speaker_config(spk)
            gens.append([fg.features(w) for w in wavs])
        raw = torch.cat(gens[0])
        mean, scale = raw.mean(0), 1.0 / raw.std(0)
        print(f"{cname}: features |x| <= {float(raw.abs().max()):.2f}",
              flush=True)
        for vname, var_scale, pooled, norm in SCALES:
            # normalized: as a `normalization` module (x - mean) * scale
            fp, ff = ([(x - mean) * scale for x in g] if norm else g
                      for g in gens)
            feats = torch.cat(fp).cpu().numpy().astype(np.float64)
            m = model(base, feats, var_scale, pooled)
            plain = GmmScorer.from_model(m, device=dev)
            fused = FusedGmmScorer.from_scorer(plain)
            cp = codes(plain, fp)
            line = (f"{cname} {vname}: in range {in_range(cp):.4f} | K2+K1 "
                    f"{agreement(codes(fused, ff), cp)} | K1 alone "
                    f"{agreement(codes(fused, fp), cp)} | K2 alone "
                    f"{agreement(codes(plain, ff), cp)}")
            if cname == "splice":
                r = np.random.default_rng(5)
                adapted = apply_model_cmllr(m, cmllr_transforms(39, 4, r),
                                            r.integers(0, 4, 2704))
                cpu_feats = [x.cpu() for x in fp]
                full = codes(GmmScorer.from_model(adapted, device="cpu"),
                             cpu_feats)
                line += (f" | full-cov card/CPU "
                         f"{agreement(codes(GmmScorer.from_model(adapted, device=dev), fp), full)}")
                assign = nearest_clusters(m.means, 64)
                gated = [GmmScorer.from_model(m, device=d).with_clustering(
                    m, assign, 64, 0.0, 0.1) for d in (dev, "cpu")]
                line += (f" | gated card/CPU "
                         f"{agreement(codes(gated[0], fp), codes(gated[1], cpu_feats))}")
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
