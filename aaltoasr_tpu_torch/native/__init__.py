"""Native host runtime: C++ LNA codec and audio decoding via ctypes.

Host copy of `aaltoasr_tpu/native/__init__.py`.  Builds
`aaltoasr_native.cpp` with ``g++`` on first use into ``build/native/``
at the repository root (the library's name carries a hash of the source
and the flags, so an edited source is rebuilt); no library is kept next
to the source.  The LNA codec has the reference's NumPy fallback, so the
package works without a compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "aaltoasr_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_FLAGS = ("-O3", "-shared", "-fPIC")

_lib = None


def _build() -> Path | None:
    """The built library's path (compiled now if needed), or None when
    the build fails."""
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(_FLAGS).encode()).hexdigest()
    so = BUILD_DIR / f"libaaltoasr_native_{digest[:16]}.so"
    if so.exists():
        return so
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return so
    except Exception as e:  # pragma: no cover - toolchain issues
        tmp.unlink(missing_ok=True)
        print(f"aaltoasr_native: build failed ({e}); using NumPy "
              "fallbacks", file=sys.stderr)
        return None


def get_lib():
    """The loaded native library, or None if unavailable."""
    global _lib
    if _lib is not None:
        return _lib if _lib is not False else None
    so = _build()
    if so is None:
        _lib = False
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:  # pragma: no cover
        _lib = False
        return None
    lib.lna_encode_u16.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8)]
    lib.lna_decode_u16.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float)]
    lib.lna_decode_u8.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float)]
    lib.wav_read_pcm16.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32)]
    lib.wav_read_pcm16.restype = ctypes.c_int64
    lib.raw_read_i16.argtypes = [
        ctypes.c_char_p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    lib.raw_read_i16.restype = ctypes.c_int64
    _lib = lib
    return lib


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def lna_encode_u16(log_probs: np.ndarray) -> bytes:
    """float32 log-probs -> big-endian 2-byte LNA payload."""
    lp = np.ascontiguousarray(log_probs, dtype=np.float32)
    lib = get_lib()
    if lib is None:
        from aaltoasr_tpu_torch.formats.lna import quantize_lna
        return quantize_lna(lp, 2)
    out = np.empty(lp.size * 2, dtype=np.uint8)
    lib.lna_encode_u16(_fptr(lp.reshape(-1)), lp.size, _u8ptr(out))
    return out.tobytes()


def lna_decode_u16(payload: bytes) -> np.ndarray:
    lib = get_lib()
    if lib is None:
        return (np.frombuffer(payload, dtype=">u2").astype(np.float32)
                / -1820.0)
    data = np.frombuffer(payload, dtype=np.uint8)
    out = np.empty(len(payload) // 2, dtype=np.float32)
    lib.lna_decode_u16(_u8ptr(data), out.size, _fptr(out))
    return out


def wav_read(path) -> tuple[np.ndarray, int]:
    """Native WAV PCM16 read; raises on failure (callers fall back)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    rate = ctypes.c_int32(0)
    n = lib.wav_read_pcm16(str(path).encode(), None, 0,
                           ctypes.byref(rate))
    if n < 0:
        raise RuntimeError(f"native WAV parse failed: {path}")
    out = np.empty(n, dtype=np.float32)
    got = lib.wav_read_pcm16(str(path).encode(), _fptr(out), n,
                             ctypes.byref(rate))
    return out[:got], int(rate.value)
