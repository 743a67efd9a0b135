"""Audio -> features -> GMM state log-probs -> LNA: the scoring pipeline.

Counterpart of `aaltoasr_tpu/models/phone_probs.py` (the reference's
PPToolbox, `aku/PhoneProbsToolbox.{hh,cc}`, and `aku/phone_probs.cc`).
Features, scoring, normalization and 2-byte quantization run on the
pipeline's device (the GPU unless the caller passes ``device="cpu"``);
the host reads audio and writes the LNA payload.
``fused=True`` runs the MFCC core as one kernel (`ops/frontend_cuda.py`)
where the configuration has it, and scores with the gather-free kernel
(`ops/gmm_cuda.py`).  A speaker configuration (-S) sets feature
parameters per speaker and utterance and folds model-namespace CMLLR
into the Gaussians; a clustering (-C) gates the Gaussian evaluation.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from aaltoasr_tpu_torch.device import resolve_device
from aaltoasr_tpu_torch.formats.feaconf import FeatureConfig
from aaltoasr_tpu_torch.formats.lna import write_lna
from aaltoasr_tpu_torch.formats.model_io import HmmModel, read_model
from aaltoasr_tpu_torch.formats.recipe import Recipe
from aaltoasr_tpu_torch.formats.spkc import SpeakerConfig
from aaltoasr_tpu_torch.frontend.audio import read_audio
from aaltoasr_tpu_torch.frontend.generator import FeatureGenerator
from aaltoasr_tpu_torch.ops.gmm import GmmScorer, quantize_lna_u16

class PhoneProbs:
    """Feature + GMM scoring pipeline for LNA generation."""

    def __init__(self, model: HmmModel | str, config: FeatureConfig | str,
                 lna_bytes: int = 2, normalize: bool = True,
                 fused: bool = False, device: torch.device | str = "cuda"):
        """fused=True runs both kernels: the MFCC core (the JAX package
        keeps its Pallas twin off by default, slower than XLA's fusion on
        the TPU; on the H100 the kernel is the faster path) and the
        gather-free state scoring.  They differ from the plain path only
        in summation order, below the 2-byte quantization step.  Plain
        diagonal GMMs only; incompatible with clustering and model-space
        CMLLR."""
        self.device = resolve_device(device)
        if isinstance(model, str):
            model = read_model(model)
        self.model = model
        # the model whose Gaussians the scorer holds (a speaker's adapted
        # pool under model-space CMLLR)
        self.scored_model = model
        self.fg = FeatureGenerator(config, fused_mfcc=fused,
                                   device=self.device)
        self.scorer = GmmScorer.from_model(model, device=self.device)
        self.fused_scorer = None
        if fused:
            from aaltoasr_tpu_torch.ops.gmm_cuda import FusedGmmScorer
            self.fused_scorer = FusedGmmScorer.from_scorer(self.scorer)
        if model.dim != self.fg.dim:
            raise ValueError(
                f"Gaussian dimension is {model.dim} but feature dimension "
                f"is {self.fg.dim}.")
        if lna_bytes not in (2, 4):
            raise ValueError("Invalid number of LNA bytes")
        self.lna_bytes = lna_bytes
        self.normalize = normalize
        self.speaker_config: SpeakerConfig | None = None
        # the speaker whose model-space transforms the scorer holds
        self._model_speaker: str | None = None

    # -- speaker adaptation ----------------------------------------------
    def read_clustering(self, path, eval_minc: float = 0.0,
                        eval_ming: float = 0.1) -> None:
        """Gaussian clustering for gated evaluation (phone_probs -C,
        `aku/phone_probs.cc:112-117`)."""
        from aaltoasr_tpu_torch.train.gcluster import read_gcl
        if self.fused_scorer is not None:
            raise ValueError("fused scoring does not support "
                             "cluster-gated evaluation")
        assign, C = read_gcl(path)
        self.scorer = self.scorer.with_clustering(
            self.model, assign, C, eval_minc, eval_ming)

    def read_speaker_config(self, path) -> None:
        self.speaker_config = SpeakerConfig.load(path)
        self._model_speaker = None

    def set_speaker(self, speaker_id: str) -> None:
        """Apply a speaker's blocks: feature parameters every call, and
        model-space CMLLR (a full-covariance scorer rebuilt on the host)
        only when the speaker changes."""
        if self.speaker_config is None or not speaker_id:
            return
        params = self.speaker_config.speaker_params(speaker_id)
        self.fg.apply_speaker_config(params)
        if speaker_id != self._model_speaker:
            self._apply_model_transforms(params)
            self._model_speaker = speaker_id

    def _apply_model_transforms(self, params: dict) -> None:
        """Model-namespace CMLLR blocks: rebuild the scorer with the
        per-class transforms folded into (full-covariance) Gaussians
        (ModelModules ConstrainedMllr; SpeakerConfig model namespace)."""
        from aaltoasr_tpu_torch.train.mllr import apply_model_cmllr
        blocks = [cfg for (ns, _name), cfg in params.items()
                  if ns == "model" and cfg.exists("classes")]
        if not blocks:
            return
        cfg = blocks[0]
        C = cfg.get_int("classes")
        D = self.model.dim
        Ws = []
        for c in range(C):
            A = np.asarray(cfg.get_float_vec(f"matrix{c}")).reshape(D, D)
            b = np.asarray(cfg.get_float_vec(f"bias{c}"))
            Ws.append(np.concatenate([b[:, None], A], axis=1))
        cls = np.asarray(cfg.get_float_vec("gauss_class"), dtype=np.int64)
        if self.fused_scorer is not None:
            raise ValueError("fused scoring does not support "
                             "model-space CMLLR (full-cov rebuild)")
        adapted = apply_model_cmllr(self.model, Ws, cls)
        self.scorer = GmmScorer.from_model(adapted, device=self.device)
        self.scored_model = adapted

    def set_utterance(self, utterance_id: str) -> None:
        if self.speaker_config is None or not utterance_id:
            return
        self.fg.apply_speaker_config(
            self.speaker_config.utterance_params(utterance_id))

    # -- scoring ----------------------------------------------------------
    def _state_ll(self, samples: torch.Tensor) -> torch.Tensor:
        """[S] samples -> [T, num_states] unnormalized log-likelihoods."""
        feats = self.fg.features(samples)
        scorer = self.fused_scorer or self.scorer
        return scorer.state_log_likelihoods(feats)[:, :scorer.num_states]

    @staticmethod
    def _reference_normalize(ll: np.ndarray) -> np.ndarray:
        """Bit-faithful reference normalization of the 4-byte LNA
        (`aku/phone_probs.cc:30,225-234`, `aku/HmmSet.cc:476-498`):
        linear likelihoods floored at 1e-50 and stored as float32, summed
        in double, then safe_log(p/Z) with the same floor."""
        p32 = np.maximum(np.exp(ll.astype(np.float64)),
                         1e-50).astype(np.float32)
        Z = p32.astype(np.float64).sum(axis=1, keepdims=True)
        Z[Z == 0.0] = 1.0
        ratio = p32.astype(np.float64) / Z
        return np.log(np.maximum(ratio, 1e-50)).astype(np.float32)

    def log_probs(self, samples) -> np.ndarray:
        """[S] samples -> [T, num_states] LNA-normalized log-probs."""
        ll = self._state_ll(samples).cpu().numpy()
        return self._reference_normalize(ll) if self.normalize else ll

    def lna_codes(self, samples) -> torch.Tensor:
        """[S] samples -> [T, num_states] 2-byte LNA codes on the device."""
        scorer = self.fused_scorer or self.scorer
        return quantize_lna_u16(scorer.lna_log_probs(self.fg.features(samples)))

    # -- LNA emission -----------------------------------------------------
    def generate_to_file(self, audio_path: str, out_path: str) -> int:
        """One utterance -> LNA file; returns the frame count."""
        samples, _rate = read_audio(audio_path, self.fg.sample_rate)
        if self.lna_bytes == 2 and self.normalize:
            codes = self.lna_codes(samples).cpu().numpy()
            header = (int(self.scorer.num_states).to_bytes(4, "big")
                      + bytes([2]))
            with open(out_path, "wb") as f:
                f.write(header + codes.astype(">u2").tobytes())
            return codes.shape[0]
        lp = self.log_probs(samples)
        write_lna(out_path, lp, self.lna_bytes)
        return lp.shape[0]

    def generate_recipe(self, recipe: Recipe, out_dir: str = "",
                        use_audio_fname: bool = False,
                        no_overwrite: bool = False, info: int = 0) -> None:
        """Process a recipe shard like the phone_probs main loop
        (`aku/phone_probs.cc:120-200`)."""
        for rinfo in recipe:
            if use_audio_fname or not rinfo.lna_path:
                out_file = os.path.basename(rinfo.audio_path) + ".lna"
            else:
                out_file = rinfo.lna_path
            if out_dir:
                out_file = os.path.join(out_dir, os.path.basename(out_file))
            if no_overwrite and os.path.exists(out_file):
                continue
            self.set_speaker(rinfo.speaker_id)
            self.set_utterance(rinfo.utterance_id)
            if info > 0:
                print(f"Processing file: {rinfo.audio_path}", file=sys.stderr)
            self.generate_to_file(rinfo.audio_path, out_file)
