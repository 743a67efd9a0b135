"""FeatureGenerator: plan the .cfg DAG once, evaluate it on torch tensors.

Counterpart of `aaltoasr_tpu/frontend/generator.py`, with the same
static plan:

* Backward pass: for each module, the total left/right context its
  consumers demand (`aku/FeatureGenerator.hh:95-100`).
* Base module (`audiofile`): frame ``t`` covers samples ``[t*adv,
  t*adv + W]`` with pre-emphasis ``s[i+1] - coef*s[i]``
  (`aku/FeatureModules.cc:371-440`); out-of-range frames are border
  copies of the first/last valid frame, realized as a clamp of the
  frame index.  A ``pre`` base (precomputed feature frames,
  `aku/FeatureModules.cc:570-760`) takes frames, not samples, and
  gathers them with the same clamp.
* Forward pass: each op maps aligned extended source slices to its own
  extended output range.

Framing is pre-emphasis over the sample stream followed by ``unfold``:
exact, and free of the convolution that cuDNN would run in TF32.  On a
CUDA tensor with ``fused_mfcc=True``, the canonical fft -> {mel -> dct,
power} subgraph runs as one hand-written kernel
(`ops/frontend_cuda.py`); elsewhere the unfused ops compute the same
math.  Speaker-dependent parameters (VTLN warp, feature transforms,
normalization) are tensors on the device that `set_parameters`
replaces; nothing else is rebuilt per speaker.

The entry points are spans ``frontend.features`` of the program's
tracer (`utils/profiling.py`), and the counter
``frontend.upload_bytes`` counts the bytes of samples they take from
host memory (inputs already on the generator's device count 0).
"""

from __future__ import annotations

import numpy as np
import torch

from aaltoasr_tpu_torch.device import resolve_device
from aaltoasr_tpu_torch.formats.feaconf import FeatureConfig
from aaltoasr_tpu_torch.frontend import modules as M
from aaltoasr_tpu_torch.utils import profiling


def patches_count(num_samples: int, window_width: int, adv: float) -> int:
    """Frames extractable from a stream: floor((S - W - 1)/adv) + 1."""
    return int((num_samples - window_width - 1) / adv) + 1


class FeatureGenerator:
    """Feature frontend for one .cfg configuration on one device."""

    def __init__(self, config: FeatureConfig | str, fused_mfcc: bool = False,
                 device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        if isinstance(config, str):
            config = FeatureConfig.load(config)
        self.config = config
        self._fused_mfcc = fused_mfcc

        base = config.base
        self.base_type = base.type
        bcfg = base.config
        if base.type == "audiofile":
            self.sample_rate = bcfg.get_int("sample_rate")
            if self.sample_rate is None:
                raise ValueError("audiofile: sample_rate is obligatory")
            self.frame_rate = bcfg.get_float("frame_rate", 125.0)
            self.window_width = bcfg.get_int(
                "window_width", int(2 * self.sample_rate / self.frame_rate))
            if not bcfg.get_int("copy_borders", 1):
                raise NotImplementedError("copy_borders=0 not supported")
            self.pre_emph_coef = bcfg.get_float("pre_emph_coef", 0.97)
            # float division like the C++ member (FeatureModules.cc:340)
            self.window_advance = self.sample_rate / self.frame_rate
            base_dim = self.window_width
        elif base.type == "pre":
            # precomputed feature files (PreModule,
            # FeatureModules.cc:570-760): dim obligatory, declared rates
            base_dim = bcfg.get_int("dim")
            if base_dim is None:
                raise ValueError("PreModule: Must set dimension")
            self.sample_rate = bcfg.get_int("sample_rate", 16000)
            self.frame_rate = bcfg.get_float("frame_rate", 125.0)
            self.window_width = 0
            self.window_advance = self.sample_rate / self.frame_rate
            self.pre_emph_coef = 0.0
            self.legacy_file = bool(bcfg.get_int("legacy_file", 0))
        else:
            raise NotImplementedError(
                f"base module type '{base.type}' not yet supported")

        # ops in config order (sources are guaranteed earlier)
        self.ops: dict[str, M.Op] = {}
        dims = {base.name: base_dim}
        for spec in config.modules[1:]:
            src_dims = [dims[s] for s in spec.sources]
            op = M.build_op(spec.type, spec.config, src_dims, self.sample_rate)
            self.ops[spec.name] = op
            dims[spec.name] = op.out_dim
        self.dims = dims

        # backward context planning
        need = {spec.name: [0, 0] for spec in config.modules}
        for spec in reversed(config.modules[1:]):
            op = self.ops[spec.name]
            nl, nr = need[spec.name]
            for s in spec.sources:
                need[s][0] = max(need[s][0], nl + op.left)
                need[s][1] = max(need[s][1], nr + op.right)
        self.need = {k: tuple(v) for k, v in need.items()}

        # the ops' runtime (speaker-dependent) parameters, on the device
        self._dev_params = {name: self._upload(params)
                            for name, op in self.ops.items()
                            if (params := op.init_params())}
        self._fusion = self._detect_mfcc_fusion()

    def _detect_mfcc_fusion(self):
        """The canonical fft -> {mel -> dct, power} subgraph, or None."""
        consumers: dict = {}
        for spec in self.config.modules[1:]:
            for s in spec.sources:
                consumers.setdefault(s, []).append(spec.name)
        type_of = {spec.name: spec.type for spec in self.config.modules[1:]}
        for spec in self.config.modules[1:]:
            if spec.type != "fft" or getattr(self.ops[spec.name], "log", 0):
                continue
            cons = consumers.get(spec.name, [])
            mels = [c for c in cons if type_of.get(c) == "mel"]
            pows = [c for c in cons if type_of.get(c) == "power"]
            if (len(mels) != 1 or len(cons) != len(mels) + len(pows)
                    or len(pows) > 1):
                continue
            mcons = consumers.get(mels[0], [])
            if len(mcons) != 1 or type_of.get(mcons[0]) != "dct":
                continue
            return {"fft": spec.name, "mel": mels[0], "dct": mcons[0],
                    "power": pows[0] if pows else None}
        return None

    # -- metadata ---------------------------------------------------------
    @property
    def dim(self) -> int:
        return self.dims[self.config.last.name]

    def num_frames(self, num_samples: int) -> int:
        """Valid frame count: last_frame + 1 (FeatureModules.cc:305-308).

        For a 'pre' base, the input unit is frames already."""
        if self.base_type == "pre":
            return int(num_samples)
        n = (num_samples - self.window_width - 1) / self.window_advance
        return int(n) + 1

    def module_dim(self, name: str) -> int:
        return self.dims[name]

    # -- speaker parameters ----------------------------------------------
    def _upload(self, params: dict) -> dict:
        return {k: torch.as_tensor(np.asarray(v), dtype=torch.float32,
                                   device=self.device)
                for k, v in params.items()}

    def set_parameters(self, module_name: str, module_config) -> None:
        """Apply a runtime parameter block to one module (.spkc path):
        its tensors on the device are replaced."""
        op = self.ops[module_name]
        self._dev_params[module_name] = self._upload(
            op.set_parameters(module_config))

    def apply_speaker_config(self, module_map: dict) -> None:
        """Apply all ('feature', name) blocks from a SpeakerConfig map."""
        for (namespace, name), cfg in module_map.items():
            if namespace == "feature":
                self.set_parameters(name, cfg)

    # -- evaluation -------------------------------------------------------
    def _base_frames(self, samples, n_frames, ext_l, T_pad, ext_r,
                     start: int = 0):
        """[B, S] samples -> [B, ext_l + T_pad + ext_r, W] pre-emphasized
        frames for output frames [start - ext_l, start + T_pad + ext_r),
        border frames clamped to each row's valid range."""
        W = self.window_width
        adv = self.window_advance
        c = self.pre_emph_coef
        if float(adv).is_integer():
            # out[t, w] = s[t*adv + w + 1] - c*s[t*adv + w] = pre[t*adv + w]
            pre = samples[:, 1:] - c * samples[:, :-1]
            patches = pre.unfold(1, W, int(adv))           # [B, Td, W]
        else:
            # non-integer advance: per-frame start offsets
            Td = patches_count(samples.shape[1], W, adv)
            ws = (torch.arange(Td, dtype=torch.float32, device=samples.device)
                  * torch.tensor(adv, dtype=torch.float32)).to(torch.int64)
            idx = ws[:, None] + torch.arange(W + 1, device=samples.device)
            win = samples[:, idx.clamp(max=samples.shape[1] - 1)]
            patches = win[..., 1:] - c * win[..., :-1]
        return self._clamped_rows(patches, n_frames, start - ext_l,
                                  start + T_pad + ext_r)

    @staticmethod
    def _clamped_rows(frames, n_frames, lo: int, hi: int):
        """Rows [lo, hi) of [B, N, W] frames, each index clamped to
        [0, n_frames[b] - 1]: border copies outside the valid range."""
        t = torch.arange(lo, hi, device=frames.device)
        last = (n_frames - 1).clamp(min=0)[:, None]
        t = torch.minimum(t[None, :].clamp(min=0), last)
        return torch.take_along_dim(frames, t[:, :, None], dim=1)

    def _run(self, samples: torch.Tensor, n_frames: torch.Tensor,
             T_pad: int, start: int = 0, params: dict | None = None
             ) -> torch.Tensor:
        """[B, S] samples ([B, N, dim] frames for a 'pre' base), [B] frame
        counts -> [B, T_pad, dim] for output frames [start, start +
        T_pad); start may be negative (border copies).  ``params``
        replaces the generator's runtime parameters for this call."""
        if self.num_frames(samples.shape[1]) < 1:
            raise ValueError("audio shorter than frame")
        config, ops, need = self.config, self.ops, self.need
        if params is None:
            params = self._dev_params
        arrays = {}
        bl, br = need[config.base.name]
        if self.base_type == "pre":
            arrays[config.base.name] = self._clamped_rows(
                samples, n_frames, start - bl, start + T_pad + br)
        else:
            arrays[config.base.name] = self._base_frames(
                samples, n_frames, bl, T_pad, br, start=start)
        fusion = (self._fusion if self._fusion is not None
                  and self._fused_mfcc and samples.is_cuda else None)
        fused_skip = set(fusion.values()) - {None} if fusion else set()
        for spec in config.modules[1:]:
            op = ops[spec.name]
            nl, nr = need[spec.name]
            if fusion and spec.name == fusion["fft"]:
                self._run_fused(arrays, spec, fusion, nl, nr, T_pad)
                continue
            if spec.name in fused_skip:
                continue
            srcs = []
            for s in spec.sources:
                snl, _snr = need[s]
                off = snl - nl - op.left
                length = T_pad + nl + nr + op.left + op.right
                srcs.append(arrays[s][:, off:off + length])
            arrays[spec.name] = op.apply(srcs, params.get(spec.name, {}))
        return arrays[config.last.name]

    def _run_fused(self, arrays, spec, fusion, nl, nr, T_pad):
        """The MFCC core as one kernel launch; the results are stored
        under the dct (and power) names, cut to their context ranges."""
        from aaltoasr_tpu_torch.ops.frontend_cuda import mfcc_core
        need = self.need
        (src,) = spec.sources
        off = need[src][0] - nl
        length = T_pad + nl + nr
        frames = arrays[src][:, off:off + length]
        B = frames.shape[0]
        fft_op = self.ops[fusion["fft"]]
        mel_op = self.ops[fusion["mel"]]
        dct_op = self.ops[fusion["dct"]]
        dev = frames.device
        cep, pw = mfcc_core(
            frames.reshape(B * length, -1).contiguous(),
            fft_op.table("basis", dev), mel_op.table("weights", dev),
            dct_op.table("matrix", dev),
            magnitude=bool(fft_op.magnitude), root=bool(mel_op.root),
            with_power=fusion["power"] is not None)

        def store(name, val):
            tnl, tnr = need[name]
            o = nl - tnl
            arrays[name] = val.reshape(B, length, -1)[:, o:o + T_pad + tnl + tnr]

        store(fusion["dct"], cep)
        if fusion["power"] is not None:
            store(fusion["power"], pw)

    # -- public entry points ---------------------------------------------
    def _samples(self, samples) -> torch.Tensor:
        on_device = (isinstance(samples, torch.Tensor)
                     and samples.device.type == self.device.type)
        out = torch.as_tensor(samples, dtype=torch.float32,
                              device=self.device)
        if not on_device:
            profiling.count("frontend.upload_bytes",
                            out.numel() * out.element_size())
        return out

    def features(self, samples, num_samples: int | None = None):
        """[S] samples -> [T, dim] features for one utterance.

        `samples` are raw int16-valued floats (the reference reads via
        sf_read_short without scaling, `aku/AudioReader.cc:197`).
        """
        with profiling.span("frontend.features"):
            samples = self._samples(samples)
            if num_samples is None:
                num_samples = samples.shape[0]
            T = self.num_frames(num_samples)
            T_pad = self.num_frames(samples.shape[0])
            n = torch.full((1,), T, dtype=torch.int64, device=self.device)
            return self._run(samples[None], n, T_pad)[0, :T]

    def features_range(self, samples, start_frame: int, end_frame: int):
        """Features for frames [start_frame, end_frame) with border
        copies outside the valid range (feacat --start-frame/--end-frame
        semantics incl. negative starts, `aku/feacat.cc:50-120`)."""
        with profiling.span("frontend.features"):
            samples = self._samples(samples)
            n = torch.full((1,), self.num_frames(samples.shape[0]),
                           dtype=torch.int64, device=self.device)
            return self._run(samples[None], n, int(end_frame - start_frame),
                             start=int(start_frame))[0]

    def features_stacked(self, samples, module: str, params: dict,
                         num_frames: int | None = None) -> torch.Tensor:
        """One utterance under B parameter sets of one module: [S]
        samples -> [B, T_pad, dim] features, T_pad = ``num_frames(S)``.

        ``params`` holds the module's runtime parameters with a leading
        axis of B (a VTLN grid: one warp matrix per candidate); the other
        modules keep the generator's, and the generator is left as it
        was.  ``num_frames`` (default: all) sets where the border copies
        start."""
        with profiling.span("frontend.features"):
            samples = self._samples(samples)
            T_pad = self.num_frames(samples.shape[0])
            B = next(iter(params.values())).shape[0]
            n = torch.full((B,), T_pad if num_frames is None else num_frames,
                           dtype=torch.int64, device=self.device)
            return self._run(samples[None].expand(B, -1), n, T_pad,
                             params={**self._dev_params,
                                     module: self._upload(params)})

    def features_batch(self, samples, num_samples):
        """[B, S] padded samples + [B] lengths -> [B, T_pad, dim].

        Rows beyond each utterance's frame count hold border copies of
        its last frame; mask with `num_frames(num_samples[i])`.
        """
        with profiling.span("frontend.features"):
            samples = self._samples(samples)
            n = torch.as_tensor(
                [self.num_frames(int(k)) for k in np.asarray(num_samples)],
                dtype=torch.int64, device=self.device)
            return self._run(samples, n, self.num_frames(samples.shape[1]))

    # -- diagnostics ------------------------------------------------------
    def print_dot_graph(self, out) -> None:
        """DOT dump of the module DAG (parity with feadot;
        `aku/FeatureGenerator.hh:90`)."""
        out.write("digraph features {\n")
        for spec in self.config.modules:
            out.write(f'  {spec.name} [label="{spec.name}\\n{spec.type}\\n'
                      f'dim={self.dims[spec.name]}"]\n')
            for s in spec.sources:
                out.write(f"  {s} -> {spec.name}\n")
        out.write("}\n")


def read_pre_file(path, dim: int, legacy_file: bool = False) -> np.ndarray:
    """Read a precomputed-feature file (PreModule format,
    FeatureModules.cc:594-640): 1-byte (legacy) or int32 dimension
    header, float32 frames."""
    with open(path, "rb") as f:
        data = f.read()
    if legacy_file:
        fdim, off = data[0], 1
    else:
        fdim = int(np.frombuffer(data, "<i4", 1)[0])
        off = 4
    if fdim != dim:
        raise ValueError("PreModule: The file has invalid dimension")
    arr = np.frombuffer(data, "<f4", offset=off)
    return arr.reshape(-1, dim).copy()
