"""Peaks, the operations and bytes of the kernels, and the arithmetic
that turns a profiler trace into device time, launches and idle gaps.

Peaks are NVIDIA's data sheet for one H100 SXM at 700 W: 3.35 TB/s of
HBM and 495 TFLOP/s of dense TF32.  The program's float32-accurate
products run as 3xTF32 (three TF32 products per float32 one), so a
float32 FLOP costs three TF32 ones: 165 TFLOP/s.  A kernel's bound is
the larger of its bytes, each moved once, over the bandwidth and its
products over that rate (the program's `chip_smoke.bound`).
"""

from __future__ import annotations

import bisect
import heapq

HBM_BYTES_PER_S = 3.35e12
TF32_FLOP_PER_S = 495e12
F32_FLOP_PER_S = TF32_FLOP_PER_S / 3      # 3xTF32: float32-accurate


def bound_s(flops: float, nbytes: float) -> float:
    """Least seconds for ``flops`` float32-accurate products and
    ``nbytes`` moved once."""
    return max(flops / F32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)


# -- the kernels -----------------------------------------------------------

def mfcc_flops(rows: int, window: int = 256, bins: int = 129,
               mel: int = 21, ceps: int = 12) -> float:
    """K2 (`mfcc_core`): the window-folded DFT, mel and DCT products of
    ``rows`` frames."""
    return 2.0 * rows * (window * 2 * bins + bins * mel + mel * ceps)


def mfcc_bytes(rows: int, window: int = 256, ceps: int = 12) -> float:
    """K2: frames read, cepstra and log power written (float32)."""
    return 4.0 * rows * (window + ceps + 1)


def gmm_flops(rows: int, states: int, K: int, dim: int) -> float:
    """K1 (`gmm_state_ll`): [rows, 2D+1] against K slabs of [2D+1,
    states]."""
    return 2.0 * (2 * dim + 1) * K * rows * states


def gmm_bytes(rows: int, states: int, K: int, dim: int) -> float:
    """K1: features read, the slabs' live rows read, the result written."""
    return 4.0 * (rows * dim + K * (2 * dim + 1) * states + rows * states)


def frontend_model_flops(frames: int) -> float:
    """The MFCC products of ``frames`` valid frames (the deltas are
    additions on 13 values and left out)."""
    return mfcc_flops(frames)


def scoring_model_flops(frames: int, gaussians: int, dim: int) -> float:
    """Every Gaussian of every frame in the expanded form: 2 (2D+1)."""
    return 2.0 * frames * gaussians * (2 * dim + 1)


def estep_model_flops(frames: int, gaussians: int, dim: int,
                      frame_positions: int) -> float:
    """Scoring, the moment sums (2 x 2 N G D) and the chain
    forward-backward (8 operations a frame and position)."""
    return (scoring_model_flops(frames, gaussians, dim)
            + 4.0 * frames * gaussians * dim + 8.0 * frame_positions)


# -- the profiler's trace --------------------------------------------------

def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def trace_events(prof) -> tuple[list, list]:
    """(device events, host events) of a finished `torch.profiler`
    run, each (name, start s, end s) on the profiler's clock.  The
    harness's ``pb:`` ranges that the profiler also puts on the device
    timeline, as annotations and not work, go with the host events."""
    dev, host = [], []
    try:
        events = prof.profiler.kineto_results.events()
        rows = [(e.name(), e.device_type(), e.start_ns() * 1e-9,
                 (e.start_ns() + e.duration_ns()) * 1e-9) for e in events]
    except AttributeError:
        rows = [(e.name, e.device_type, e.time_range.start * 1e-6,
                 e.time_range.end * 1e-6) for e in prof.events()]
    for name, dtype, t0, t1 in rows:
        if dtype == dtype.CUDA:
            # the harness's record_function ranges also appear on the
            # device timeline, as annotations, not work
            (host if name.startswith("pb:") else dev).append((name, t0, t1))
        elif dtype == dtype.CPU:
            host.append((name, t0, t1))
    dev.sort(key=lambda e: e[1])
    return dev, host


def merged(intervals) -> list:
    """Union of (start, end) intervals, sorted."""
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Profile:
    """One profiled slice: device and host events, and its host-clock
    length ``window_s``."""

    def __init__(self, device_events: list, host_events: list,
                 window_s: float):
        self.dev = device_events
        self.host = host_events
        self.window_s = window_s
        self.spans = {}
        for name, t0, t1 in host_events:
            if name.startswith("pb:"):
                self.spans.setdefault(name[3:], []).append((t0, t1))
        # a range seen on both timelines counts once: ranges of one name
        # never nest, so one that overlaps the range before it is a copy
        for k, v in self.spans.items():
            kept: list = []
            for r in sorted(v):
                if not kept or r[0] >= kept[-1][1]:
                    kept.append(r)
            self.spans[k] = kept

    def busy_s(self) -> float:
        return sum(b - a for a, b in merged((e[1], e[2]) for e in self.dev))

    def idle_pct(self):
        if not self.dev or self.window_s <= 0:
            return None
        return 100.0 * max(0.0, 1.0 - self.busy_s() / self.window_s)

    def kernels(self, within: str | None = None) -> list:
        """Kernel events (copies and fills apart), those starting inside
        span ``within`` only if given."""
        ks = [e for e in self.dev if not _is_copy(e[0])]
        if within is None:
            return ks
        spans = sorted(self.spans.get(within, []))
        starts = [a for a, _ in spans]
        out = []
        for e in ks:
            i = bisect.bisect_right(starts, e[1]) - 1
            if i >= 0 and e[1] <= spans[i][1]:
                out.append(e)
        return out

    def kernel_s(self, name_part: str) -> float:
        return sum(t1 - t0 for n, t0, t1 in self.kernels() if name_part in n)

    def top_ops(self, n: int = 10) -> list:
        total: dict = {}
        for name, t0, t1 in self.dev:
            total[name] = total.get(name, 0.0) + (t1 - t0)
        return [[k[:120], v] for k, v in
                sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle device time between kernels, summed by the innermost
        host event running at each gap's middle (span > op)."""
        busy = merged((e[1], e[2]) for e in self.dev)
        host = sorted(self.host, key=lambda e: e[1])
        active: list = []          # heap of (end, start, name)
        i = 0
        total: dict = {}
        for (_, b0), (a1, _) in zip(busy, busy[1:]):
            mid = 0.5 * (b0 + a1)
            while i < len(host) and host[i][1] <= mid:
                heapq.heappush(active, (host[i][2], host[i][1], host[i][0]))
                i += 1
            while active and active[0][0] < mid:
                heapq.heappop(active)
            span = [e for e in active if e[2].startswith("pb:")]
            ops = [e for e in active if not e[2].startswith("pb:")]
            name = max(span, key=lambda e: e[1])[2][3:] if span else "-"
            if ops:
                name += " > " + max(ops, key=lambda e: e[1])[2]
            total[name] = total.get(name, 0.0) + (a1 - b0)
        return [[k[:120], v] for k, v in
                sorted(total.items(), key=lambda kv: -kv[1])[:n]]
