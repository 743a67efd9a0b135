"""Sufficient-statistics accumulators with reference-compatible dumps.

Host copy of `aaltoasr_tpu/train/accumulators.py`.

In-memory layout is SoA NumPy arrays, filled from the device E-step's
batched statistics (`train/driver.py`) in place of the reference's
per-object accumulators; dumps merge by `load`, as the reference's
`combine_stats` does (`aku/combine_stats.cc:17`).  The dump/load formats are
bit-compatible with the reference so dumps interoperate both ways:

* .gks (binary LE): int num_gaussians, int dim, int statistics_mode;
  per Gaussian: int index, then per accumulated buffer
  [int accum_pos, int feacount, double gamma, double aux_gamma,
  float mean[D] (sum of gamma*x), float second_moment (D floats diagonal)],
  terminated by int -1 (`aku/HmmSet.cc:605-628`,
  `aku/Distributions.cc:305-316, 157-176`).
* .mcs (text): num_pdfs, statistics_mode; per mixture, per buffer a line
  "pos size (ptr gamma)... aux_gamma mixture_ll", then "-1"
  (`aku/HmmSet.cc:582-601`, `aku/Distributions.cc:2192-2208`).
* .phs (text): num transitions; "source target_offset occupancy" lines
  (`aku/HmmSet.cc:555-578`).
* .lls (text): "Numerator loglikelihood: <value>" (`aku/stats.cc:776-790`).

Statistics-mode bitmask and buffer ids follow `aku/Distributions.hh:14-29`:
ML=1 (buffer 0), MMI=4 (buffer 1), MPE_NUM=8 (buffer 2), MPE_DEN=16
(buffer 3).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

# statistics mode bits (Distributions.hh:15-19)
PDF_ML_STATS = 1
PDF_ML_FULL_STATS = 2
PDF_MMI_STATS = 4
PDF_MPE_NUM_STATS = 8
PDF_MPE_DEN_STATS = 16

# accumulator buffer ids (Distributions.hh:29)
ML_BUF, MMI_BUF, MPE_NUM_BUF, MPE_DEN_BUF = 0, 1, 2, 3

_MODE_TO_BUFFERS = {
    PDF_ML_STATS: (ML_BUF,),
    PDF_MMI_STATS: (MMI_BUF,),
    PDF_MPE_NUM_STATS: (MPE_NUM_BUF,),
    PDF_MPE_DEN_STATS: (MPE_DEN_BUF,),
}


def buffers_for_mode(mode: int) -> tuple:
    bufs = set()
    if mode & (PDF_ML_STATS | PDF_ML_FULL_STATS):
        bufs.add(ML_BUF)
    if mode & PDF_MMI_STATS:
        bufs.update((ML_BUF, MMI_BUF))
    if mode & PDF_MPE_NUM_STATS:
        bufs.add(MPE_NUM_BUF)
    if mode & PDF_MPE_DEN_STATS:
        bufs.add(MPE_DEN_BUF)
    return tuple(sorted(bufs))


@dataclass
class BufferStats:
    """One accumulator buffer's arrays (cf. the per-PDF accumulators)."""

    gamma: np.ndarray        # [G] occupancy
    mean_acc: np.ndarray     # [G, D] sum gamma*x
    sec_acc: np.ndarray      # [G, D] sum gamma*x^2 (diagonal stats)
    feacount: np.ndarray     # [G] int accumulate-call counts
    aux_gamma: np.ndarray    # [G] (MPE machinery; zero for ML)
    mix_gamma: np.ndarray    # [S, K] per-mixture component occupancies
    mix_aux_gamma: np.ndarray  # [S]
    mix_ll: np.ndarray       # [S]
    full_acc: np.ndarray | None = None   # [G, D, D] full second moments
                                         # (PDF_ML_FULL_STATS)

    @classmethod
    def zeros(cls, G: int, D: int, S: int, K: int) -> "BufferStats":
        return cls(
            gamma=np.zeros(G), mean_acc=np.zeros((G, D)),
            sec_acc=np.zeros((G, D)), feacount=np.zeros(G, dtype=np.int64),
            aux_gamma=np.zeros(G), mix_gamma=np.zeros((S, K)),
            mix_aux_gamma=np.zeros(S), mix_ll=np.zeros(S))

    def ensure_full(self) -> np.ndarray:
        if self.full_acc is None:
            G, D = self.mean_acc.shape
            self.full_acc = np.zeros((G, D, D))
        return self.full_acc

    def add(self, other: "BufferStats") -> None:
        self.gamma += other.gamma
        self.mean_acc += other.mean_acc
        self.sec_acc += other.sec_acc
        self.feacount += other.feacount
        self.aux_gamma += other.aux_gamma
        self.mix_gamma += other.mix_gamma
        self.mix_aux_gamma += other.mix_aux_gamma
        self.mix_ll += other.mix_ll
        if other.full_acc is not None:
            self.ensure_full()
            self.full_acc += other.full_acc


@dataclass
class HmmStats:
    """Full model statistics: Gaussian/mixture buffers + transitions + LL."""

    mode: int
    dim: int
    num_gaussians: int
    mixture_sizes: list              # actual K per mixture (for dumps)
    mixture_pointers: list           # component Gaussian ids per mixture
    buffers: dict = field(default_factory=dict)   # buf id -> BufferStats
    trans_acc: np.ndarray | None = None           # [NT] occupancies
    trans_source: np.ndarray | None = None        # [NT] tied-state per slot
    trans_offset: np.ndarray | None = None        # [NT] target offset per slot
    num_ll: float = 0.0              # numerator total log-likelihood
    den_ll: float = 0.0
    num_frames: int = 0
    mpe_score: float = 0.0           # summed expected accuracy (MPE)

    @classmethod
    def zeros(cls, model, table, mode: int = PDF_ML_STATS) -> "HmmStats":
        G, D = model.means.shape
        S = model.num_states
        K = max((len(ix) for ix, _ in model.mixtures), default=1)
        stats = cls(
            mode=mode, dim=D, num_gaussians=G,
            mixture_sizes=[len(ix) for ix, _ in model.mixtures],
            mixture_pointers=[np.asarray(ix) for ix, _ in model.mixtures],
            trans_acc=np.zeros(table.num_slots),
            trans_source=np.asarray(table.source),
            trans_offset=np.asarray(table.offset))
        for b in buffers_for_mode(mode):
            stats.buffers[b] = BufferStats.zeros(G, D, S, K)
        return stats

    def add(self, other: "HmmStats") -> None:
        assert self.mode == other.mode
        for b, buf in other.buffers.items():
            self.buffers[b].add(buf)
        if other.trans_acc is not None:
            self.trans_acc += other.trans_acc
        self.num_ll += other.num_ll
        self.den_ll += other.den_ll
        self.num_frames += other.num_frames
        self.mpe_score += other.mpe_score

    # -- reference-format dumps ------------------------------------------
    def dump(self, base: str) -> None:
        self.dump_gks(base + ".gks")
        self.dump_mcs(base + ".mcs")
        self.dump_phs(base + ".phs")
        self.dump_lls(base + ".lls")

    def dump_gks(self, path) -> None:
        with open(path, "wb") as f:
            f.write(struct.pack("<iii", self.num_gaussians, self.dim,
                                self.mode))
            for g in range(self.num_gaussians):
                f.write(struct.pack("<i", g))
                for b in sorted(self.buffers):
                    buf = self.buffers[b]
                    f.write(struct.pack("<i", b))
                    f.write(struct.pack("<idd", int(buf.feacount[g]),
                                        float(buf.gamma[g]),
                                        float(buf.aux_gamma[g])))
                    f.write(buf.mean_acc[g].astype("<f4").tobytes())
                    if (b == ML_BUF and self.mode & PDF_ML_FULL_STATS
                            and buf.full_acc is not None):
                        tri = buf.full_acc[g][np.tril_indices(self.dim)]
                        f.write(tri.astype("<f4").tobytes())
                    else:
                        f.write(buf.sec_acc[g].astype("<f4").tobytes())
                f.write(struct.pack("<i", -1))

    def load_gks(self, path) -> None:
        with open(path, "rb") as f:
            data = f.read()
        off = 0
        G, D, mode = struct.unpack_from("<iii", data, off)
        off += 12
        if G != self.num_gaussians or D != self.dim:
            raise ValueError("gks dump does not match model")
        for _ in range(G):
            (g,) = struct.unpack_from("<i", data, off)
            off += 4
            while True:
                (b,) = struct.unpack_from("<i", data, off)
                off += 4
                if b < 0:
                    break
                fc, gam, aux = struct.unpack_from("<idd", data, off)
                off += 4 + 16
                mean = np.frombuffer(data, "<f4", D, off)
                off += 4 * D
                full = None
                if b == ML_BUF and mode & PDF_ML_FULL_STATS:
                    ntri = D * (D + 1) // 2
                    tri = np.frombuffer(data, "<f4", ntri, off)
                    off += 4 * ntri
                    full = np.zeros((D, D))
                    full[np.tril_indices(D)] = tri
                    full = full + np.tril(full, -1).T
                    sec = np.diag(full)
                else:
                    sec = np.frombuffer(data, "<f4", D, off)
                    off += 4 * D
                buf = self.buffers.setdefault(
                    b, BufferStats.zeros(
                        self.num_gaussians, self.dim,
                        len(self.mixture_sizes),
                        self.buffers[min(self.buffers)].mix_gamma.shape[1]
                        if self.buffers else 1))
                buf.feacount[g] += fc
                buf.gamma[g] += gam
                buf.aux_gamma[g] += aux
                buf.mean_acc[g] += mean
                buf.sec_acc[g] += sec
                if full is not None:
                    buf.ensure_full()
                    buf.full_acc[g] += full

    def dump_mcs(self, path) -> None:
        with open(path, "w") as f:
            f.write(f"{len(self.mixture_sizes)}\n{self.mode}\n")
            for s, size in enumerate(self.mixture_sizes):
                f.write(f"{s}\n")   # pdf index line (HmmSet.cc:594)
                for b in sorted(self.buffers):
                    buf = self.buffers[b]
                    parts = [str(b), str(size)]
                    for k in range(size):
                        parts.append(str(int(self.mixture_pointers[s][k])))
                        parts.append(f"{buf.mix_gamma[s, k]:.10g}")
                    parts.append(f"{buf.mix_aux_gamma[s]:.10g}")
                    parts.append(f"{buf.mix_ll[s]:.10g}")
                    f.write(" ".join(parts) + "\n")
                f.write("-1\n")

    def load_mcs(self, path) -> None:
        with open(path) as f:
            tokens = f.read().split()
        it = iter(tokens)
        S = int(next(it))
        int(next(it))  # mode
        for s in range(S):
            assert int(next(it)) == s   # pdf index (HmmSet.cc:594)
            while True:
                b = int(next(it))
                if b < 0:
                    break
                size = int(next(it))
                buf = self.buffers[b]
                for k in range(size):
                    ptr = int(next(it))
                    assert ptr == int(self.mixture_pointers[s][k])
                    buf.mix_gamma[s, k] += float(next(it))
                buf.mix_aux_gamma[s] += float(next(it))
                buf.mix_ll[s] += float(next(it))

    def dump_phs(self, path) -> None:
        with open(path, "w") as f:
            f.write(f"{len(self.trans_acc)}\n")
            for t in range(len(self.trans_acc)):
                f.write(f"{self.trans_source[t]} {self.trans_offset[t]} "
                        f"{self.trans_acc[t]:.10g}\n")

    def load_phs(self, path, table=None) -> None:
        src_ref = self.trans_source if table is None else table.source
        off_ref = self.trans_offset if table is None else table.offset
        with open(path) as f:
            lines = f.read().split("\n")
        n = int(lines[0])
        if n != len(self.trans_acc):
            raise ValueError("phs dump does not match model")
        # the reference writer skips never-accumulated slots
        # (HmmSet.cc:567 `if (m_accumulated[t])`): match lines to
        # slots by (source, offset)
        slot_of = {(int(s), int(o)): i
                   for i, (s, o) in enumerate(zip(src_ref, off_ref))}
        for line in lines[1:]:
            if not line.strip():
                continue
            src, off, occ = line.split()
            self.trans_acc[slot_of[(int(src), int(off))]] += float(occ)

    def dump_lls(self, path) -> None:
        # same keys as the reference E-step worker (aku/stats.cc:778-797)
        with open(path, "w") as f:
            f.write(f"Numerator loglikelihood: {self.num_ll:.12g}\n")
            if self.mode & (PDF_MMI_STATS | PDF_MPE_DEN_STATS):
                f.write(f"Denominator loglikelihood: {self.den_ll:.12g}\n")
            if self.mode & PDF_MMI_STATS:
                f.write(f"MMI score: {self.num_ll - self.den_ll:.12g}\n")
            if self.mode & (PDF_MPE_NUM_STATS | PDF_MPE_DEN_STATS):
                f.write(f"MPE score: {self.mpe_score:.12g}\n")
            f.write(f"Number of frames: {self.num_frames}\n")

    def load_lls(self, path) -> None:
        with open(path) as f:
            for line in f:
                if line.startswith("Numerator loglikelihood:"):
                    self.num_ll += float(line.split(":")[1])
                elif line.startswith("Denominator loglikelihood:"):
                    self.den_ll += float(line.split(":")[1])
                elif line.startswith("MPE score:"):
                    self.mpe_score += float(line.split(":")[1])
                elif line.startswith("Number of frames:"):
                    self.num_frames += int(float(line.split(":")[1]))

    def load(self, base: str, table=None) -> None:
        """Accumulate a full dump set (combine_stats semantics)."""
        self.load_gks(base + ".gks")
        self.load_mcs(base + ".mcs")
        self.load_phs(base + ".phs", table)
        self.load_lls(base + ".lls")
