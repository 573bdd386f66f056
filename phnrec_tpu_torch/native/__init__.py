"""Native (C++) host-runtime kernels, bound via ctypes.

Counterpart of phnrec_tpu/native/__init__.py, with the same C ABI
(``src/phnrec_native.cpp``, a copy of phnrec_tpu's):

* waveform ingestion (lin16/A-law decode + DC/scale/dither, srec.cpp:709-791)
* HTK big-endian byte swaps (matrix.h:2576-2590)
* batched Viterbi history backtrack (phndec.cpp:236-302)
* batched HResults-style alignment (STKLib/labels.C:525-527)
* the reference-parity LCG (myrand.cpp:17-28)

This is host code, not a device kernel.  The shared library is compiled
with ``g++`` at first use into ``build/phnrec_tpu_torch/`` at the
repository root (beside the CUDA kernels' libraries), keyed by a hash of
the source and the flags, and written under a temporary name then renamed,
so concurrent processes never load a half-written file.  Every caller has a
NumPy / Python route that gives identical results: ``available()`` gates
the native one, so a machine without ``g++`` still decodes (set
``PHNREC_NO_NATIVE`` to force the Python routes).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "phnrec_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "phnrec_tpu_torch"
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-fvisibility=hidden"]
_ABI = 1

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def lib_path() -> Path:
    """The library's path, keyed by the source's and the flags' hash."""
    h = hashlib.sha256(SRC.read_bytes()
                       + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libphnrec_native-{h}.so"


def _build(out: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}"
                        ".tmp")
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except Exception:
        tmp.unlink(missing_ok=True)
        return False


def _bind(lib: ctypes.CDLL) -> None:
    i8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.pn_abi_version.restype = ctypes.c_int32
    lib.pn_convert_waveform.restype = ctypes.c_int64
    lib.pn_convert_waveform.argtypes = [
        i8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_uint32, f32p, ctypes.c_int64]
    lib.pn_swap4.argtypes = [i8p, ctypes.c_int64]
    lib.pn_swap2.argtypes = [i8p, ctypes.c_int64]
    lib.pn_backtrack_batch.restype = ctypes.c_int32
    lib.pn_backtrack_batch.argtypes = [
        i32p, i32p, i32p, f32p, i32p, ctypes.c_int64, ctypes.c_int64,
        i32p, i32p, i32p, f32p, i32p, ctypes.c_int64]
    lib.pn_align.argtypes = [i32p, ctypes.c_int32, i32p, ctypes.c_int32, i32p]
    lib.pn_align_batch.argtypes = [
        i32p, i64p, i32p, i64p, ctypes.c_int64, i32p]


def _get() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("PHNREC_NO_NATIVE"):
            return None
        try:
            path = lib_path()
            if not path.exists() and not _build(path):
                return None
            lib = ctypes.CDLL(str(path))
            _bind(lib)
            if lib.pn_abi_version() == _ABI:
                _lib = lib
        except Exception:
            _lib = None
    return _lib


def available() -> bool:
    return _get() is not None


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def convert_waveform(raw: bytes, fmt: str = "lin16", scale: float = 1.0,
                     dc_shift: float = 0.0, noise_level: float = 0.0,
                     seed: int = 1) -> Tuple[np.ndarray, int]:
    """Native ConvertWaveformFormat: bytes -> (float32 wave >=200, n)."""
    lib = _get()
    assert lib is not None
    fmt_id = {"lin16": 0, "alaw": 1}[fmt]
    n = len(raw) // 2 if fmt == "lin16" else len(raw)
    out = np.empty(max(n, 200), np.float32)
    buf = np.frombuffer(raw, np.uint8)
    got = lib.pn_convert_waveform(
        _ptr(buf, ctypes.c_uint8), len(raw), fmt_id, scale, dc_shift,
        noise_level, seed, _ptr(out, ctypes.c_float), out.shape[0])
    assert got == n
    return out, n


def swap4_inplace(a: np.ndarray) -> None:
    lib = _get()
    assert lib is not None and a.flags.c_contiguous and a.itemsize == 4
    lib.pn_swap4(_ptr(a.view(np.uint8), ctypes.c_uint8), a.size)


def backtrack_batch(max_phn: np.ndarray, prev_phn: np.ndarray,
                    length: np.ndarray, alpha: np.ndarray,
                    n_frames: np.ndarray
                    ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray,
                                    np.ndarray]]:
    """[B, T] history arrays -> per-row (start, end, phn_id, like) arrays
    in forward time order (PhnDec::Done replay, phndec.cpp:236-302)."""
    lib = _get()
    assert lib is not None
    max_phn = np.ascontiguousarray(max_phn, np.int32)
    prev_phn = np.ascontiguousarray(prev_phn, np.int32)
    length = np.ascontiguousarray(length, np.int32)
    alpha = np.ascontiguousarray(alpha, np.float32)
    n_frames = np.ascontiguousarray(n_frames, np.int32)
    B, T = max_phn.shape
    cap = T + 1
    s = np.empty((B, cap), np.int32)
    e = np.empty((B, cap), np.int32)
    p = np.empty((B, cap), np.int32)
    lk = np.empty((B, cap), np.float32)
    cnt = np.empty(B, np.int32)
    rc = lib.pn_backtrack_batch(
        _ptr(max_phn, ctypes.c_int32), _ptr(prev_phn, ctypes.c_int32),
        _ptr(length, ctypes.c_int32), _ptr(alpha, ctypes.c_float),
        _ptr(n_frames, ctypes.c_int32), B, T,
        _ptr(s, ctypes.c_int32), _ptr(e, ctypes.c_int32),
        _ptr(p, ctypes.c_int32), _ptr(lk, ctypes.c_float),
        _ptr(cnt, ctypes.c_int32), cap)
    assert rc == 0
    return [(s[b, :cnt[b]][::-1].copy(), e[b, :cnt[b]][::-1].copy(),
             p[b, :cnt[b]][::-1].copy(), lk[b, :cnt[b]][::-1].copy())
            for b in range(B)]


def align(ref_ids: np.ndarray, hyp_ids: np.ndarray
          ) -> Tuple[int, int, int, int]:
    """HTK-cost alignment -> (H, D, S, I)."""
    lib = _get()
    assert lib is not None
    r = np.ascontiguousarray(ref_ids, np.int32)
    h = np.ascontiguousarray(hyp_ids, np.int32)
    out = np.zeros(4, np.int32)
    lib.pn_align(_ptr(r, ctypes.c_int32), r.size,
                 _ptr(h, ctypes.c_int32), h.size, _ptr(out, ctypes.c_int32))
    return int(out[0]), int(out[1]), int(out[2]), int(out[3])


def myrand_sequence(seed: int, n: int) -> np.ndarray:
    """Reference-parity LCG stream (myrand.cpp:17-28), for tests."""
    state = np.uint32(seed)
    out = np.empty(n, np.int32)
    for i in range(n):
        state = np.uint32(
            (np.uint64(state) * np.uint64(1103515245) + np.uint64(12345))
            & np.uint64(0xFFFFFFFF))
        out[i] = np.int32((int(state) >> 16) & 0x7FFFFFFF)
    return out
