"""The dense step's node pass and beam pass as two CUDA kernel launches a
frame.

`node_pass` runs `csrc/dense_node.cu`'s node kernel on CUDA tensors: for
every row and node of the [B, N] state, the in-arc relaxation (the
duration bonus, the self/next/skip shifts, the irregular in-arcs and
their payloads), re-entry's fan-in of the frame's top-C word ends at the
entry nodes, and the observation add, reading the old state once and
writing the new state once, with each row's maximum.  In freeze mode a
row past its frame count copies its old state.  `beam_pass` then applies
the global beam in place, and takes each row's first best node for
`fin`.  They compute what `DenseBeamSearch._node_pass_plain` and
`_beam_pass_plain` compute, bit for bit, and the search picks between
them by device.  The kernels replace no TPU kernel: the JAX package's
dense step is XLA ops.

The kernels take the state's rows padded to a multiple of `VEC` nodes
(`padded`), so every access is a 16-byte load or store, and their
per-node tables in the same padding (`tables`).  Counters:
``dense.node.launches`` and ``dense.beam.launches``, one a launch;
``dense.node_pass.rows``, B a node-pass launch.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from aaltoasr_tpu_torch.ops.cuda_build import check, load_library
from aaltoasr_tpu_torch.ops.logsemiring import LOG_ZERO
from aaltoasr_tpu_torch.utils import profiling

SOURCE = "dense_node.cu"
VEC = 4             # nodes a thread, as in the source
C = 4               # re-entries a frame (`search_dense.REENTRY_WIDTH`)
# a duration bonus below this leaves LOG_ZERO unchanged in float32 (half
# its ulp is 3.8e22), so a dead source's bonus need not be read
DEAD_BONUS = 1e21
STATE_DTYPES = (torch.float32, torch.float32, torch.int64, torch.int64,
                torch.int64, torch.float32, torch.bool)
# r_total, r_alive, r_pair, r_lms, r_lm, r_rec, r_bo
REENTRY_DTYPES = (torch.float32, torch.bool, torch.int64, torch.float32,
                  torch.int64, torch.int64, torch.float32)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    vp, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.dense_node_launch.argtypes = ([vp] * 34 + [ll] + [vp] * 3
                                      + [i] * 12 + [vp])
    lib.dense_node_launch.restype = i
    lib.dense_beam_launch.argtypes = [vp] * 13 + [f, f] + [i] * 5 + [vp]
    lib.dense_beam_launch.restype = i
    lib.dense_node_vec.restype = i
    lib.dense_node_plan.argtypes = [i, i, ctypes.POINTER(i),
                                    ctypes.POINTER(i)]
    lib.dense_node_plan.restype = i
    if lib.dense_node_vec() != VEC:
        raise RuntimeError(f"dense_node: the library's VEC differs from {VEC}")
    return lib


def width(N: int) -> int:
    """The padded row length of N nodes."""
    return -(-N // VEC) * VEC


def plan(B: int, N: int) -> tuple[int, int, int]:
    """(node tiles, row groups, rows a block): both kernels' grid on the
    current card for B rows of N nodes."""
    tiles, groups = ctypes.c_int(), ctypes.c_int()
    rows = _lib().dense_node_plan(B, width(N), ctypes.byref(tiles),
                                  ctypes.byref(groups))
    return tiles.value, groups.value, rows


def _pad(x: torch.Tensor, ld: int, fill=0) -> torch.Tensor:
    """x [N, ...] -> [ld, ...], the rows past N ``fill``."""
    out = torch.full((ld,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                     device=x.device)
    out[:x.shape[0]] = x
    return out


def tables(t: dict, grp_lp: np.ndarray, max_dur: int,
           has_durations: bool, NR: int) -> dict:
    """The kernels' tables from a search's tables ``t``: per-node arrays
    padded to `width` (int32 indices; the four duration parameters as one
    [ld, 4] array), the irregular in-arcs as int32 sources beside their
    terms with the entries a target scans (its arcs and one padding
    entry: the padding entries are equal, and the first wins a tie), the
    pair membership as bytes, and the scalars."""
    N = t["pdf"].shape[0]
    ld = width(N)
    Mi, F = t["grp_src"].shape
    n_arcs = (grp_lp > LOG_ZERO / 2).sum(axis=1)
    dur = torch.stack([t[k] for k in ("dur_valid", "dur_lncoef", "dur_invb",
                                      "dur_const")], dim=1)
    d = dur.double().abs().cpu().numpy()
    bound = float(np.max(d[:, 0] * (d[:, 1] * math.log(max(max_dur, 1))
                                    + max_dur * d[:, 2] + d[:, 3]),
                         initial=0.0))
    if bool((t["we_pair"] < 0).any()):
        raise ValueError("dense_node: negative pair rows")
    M = t["left_mem"].shape[1]
    i32 = torch.int32
    return {
        "ts_self": _pad(t["ts_self"], ld), "ts_prev": _pad(t["ts_prev"], ld),
        "ts_skip": _pad(t["ts_skip"], ld), "dur4": _pad(dur, ld),
        "pdf": _pad(t["pdf"].to(i32), ld),
        "grp_inv": _pad(t["grp_inv"].to(i32), ld, Mi),
        "entry_inv": _pad(t["entry_inv"].to(i32), ld, M),
        "grp_src": t["grp_src"].to(i32).contiguous(),
        "ts_grp": t["ts_grp"].contiguous(),
        "grp_cnt": torch.as_tensor(np.minimum(F, n_arcs + 1), dtype=i32,
                                   device=dur.device),
        "left_mem": t["left_mem"].to(torch.uint8).contiguous(),
        "first_mem": t["first_mem"].to(torch.uint8).contiguous(),
        "N": N, "ld": ld, "Mi": Mi, "F": F, "M": M,
        "NR": NR, "max_dur": int(max_dur), "has_dur": bool(has_durations),
        "dead_skip": bound < DEAD_BONUS,
    }


def padded(state) -> tuple:
    """[B, N] state arrays -> copies as [B, N] views of zeroed [B, ld]
    storage, ld = `width` (N)."""
    B, N = state[0].shape
    ld = width(N)
    out = []
    for x in state:
        buf = torch.zeros((B, ld), dtype=x.dtype, device=x.device)
        buf[:, :N] = x
        out.append(buf[:, :N])
    return tuple(out)


class Scratch:
    """The rows' scratch of one decode: ``acc`` (row maxima as ordered
    keys), ``arg`` (the best node's key), ``done`` (blocks finished), all
    zero between frames, and ``rowmax``."""

    def __init__(self, B: int, device):
        self.acc = torch.zeros(B, dtype=torch.int32, device=device)
        self.arg = torch.zeros(B, dtype=torch.int64, device=device)
        self.done = torch.zeros(B, dtype=torch.int32, device=device)
        self.rowmax = torch.empty(B, dtype=torch.float32, device=device)


def _check_state(state, B: int, N: int, ld: int, name: str) -> None:
    for x, dtype in zip(state, STATE_DTYPES):
        if (x.device.type != "cuda" or x.dtype != dtype
                or tuple(x.shape) != (B, N) or x.stride() != (ld, 1)):
            raise ValueError(
                f"dense_node: {name} array {tuple(x.shape)} {x.dtype} "
                f"stride {x.stride()} on {x.device}, not ({B}, {N}) "
                f"{dtype} stride ({ld}, 1) on a card (see `padded`)")


def node_pass(kt: dict, state, out, obs, frame: int, reentry, n_frames,
              freeze: bool, scr: Scratch):
    """Old ``state`` -> new state written into ``out`` (both `padded`
    [B, N] arrays: total, lms, lm, dur, rec, bo, alive), for frame
    ``frame`` of obs [B, T, S]; ``reentry`` the frame's [B, C] arrays
    (r_total, r_alive, r_pair, r_lms, r_lm, r_rec, r_bo); n_frames [B]
    int64.  -> out.  The rows' maxima stay in ``scr`` for `beam_pass`,
    which leaves them in ``scr.rowmax`` (-inf at a frozen row)."""
    B, N = state[0].shape
    ld = kt["ld"]
    if N != kt["N"]:
        raise ValueError(f"dense_node: {N} nodes, the tables have {kt['N']}")
    _check_state(state, B, N, ld, "old")
    _check_state(out, B, N, ld, "new")
    if {x.data_ptr() for x in state} & {x.data_ptr() for x in out}:
        raise ValueError("dense_node: the new state overlaps the old")
    r = [x.contiguous() for x in reentry]
    for x, dtype in zip(r, REENTRY_DTYPES):
        if x.dtype != dtype or tuple(x.shape) != (B, C):
            raise ValueError(f"dense_node: a re-entry array is "
                             f"{tuple(x.shape)} {x.dtype}, not ({B}, {C}) "
                             f"{dtype}")
    if obs.dtype != torch.float32 or obs.stride(2) != 1:
        raise ValueError("dense_node: obs must be float32 with unit stride "
                         "over states")
    o = obs[:, frame]
    lib = _lib()
    err = lib.dense_node_launch(
        *(x.data_ptr() for x in state), *(x.data_ptr() for x in out),
        *(kt[k].data_ptr() for k in (
            "ts_self", "ts_prev", "ts_skip", "dur4", "pdf", "grp_inv",
            "entry_inv", "grp_src", "ts_grp", "grp_cnt", "left_mem",
            "first_mem")),
        *(x.data_ptr() for x in r), o.data_ptr(), o.stride(0),
        n_frames.data_ptr(), scr.acc.data_ptr(), scr.rowmax.data_ptr(),
        frame, B, N, ld, kt["Mi"], kt["F"], kt["M"], kt["NR"],
        kt["max_dur"], int(kt["has_dur"]), int(freeze), int(kt["dead_skip"]),
        torch.cuda.current_stream(obs.device).cuda_stream)
    check(lib, err, "dense_node")
    profiling.count("dense.node.launches")
    profiling.count("dense.node_pass.rows", B)
    return out


def beam_pass(state, n_frames, frame: int, freeze: bool, beam: float,
              lm_scale: float, fin, scr: Scratch):
    """The global beam on a node pass's ``state``, in place on its total
    and alive, and ``fin`` (rec [B] int64, max, am, lms [B] float32)
    written in place where frame < n_frames.  -> (state, fin)."""
    total, lms, _lm, _dur, rec, _bo, alive = state
    B, N = total.shape
    ld = total.stride(0)
    for x, dtype in zip(fin, (torch.int64,) + (torch.float32,) * 3):
        if x.dtype != dtype or tuple(x.shape) != (B,) or not x.is_contiguous():
            raise ValueError(f"dense_node: a fin array is {tuple(x.shape)} "
                             f"{x.dtype}, not ({B},) {dtype}")
    lib = _lib()
    err = lib.dense_beam_launch(
        total.data_ptr(), alive.data_ptr(), lms.data_ptr(), rec.data_ptr(),
        n_frames.data_ptr(), scr.acc.data_ptr(), scr.arg.data_ptr(),
        scr.done.data_ptr(), scr.rowmax.data_ptr(),
        *(x.data_ptr() for x in fin), beam, -lm_scale, frame, B, N, ld,
        int(freeze), torch.cuda.current_stream(total.device).cuda_stream)
    check(lib, err, "dense_beam")
    profiling.count("dense.beam.launches")
    return state, fin
