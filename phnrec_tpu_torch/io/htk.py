"""HTK parameter (feature) file I/O.

Copy of phnrec_tpu/io/htk.py (numpy-only host code, kept in step with it).

Format (ref matrix.h:76-82, 2506-2573): a 12-byte big-endian header

    int32  nSamples     number of frames
    int32  sampPeriod   frame period in 100 ns units (reference always 100000)
    int16  sampSize     bytes per frame (= columns * 4)
    int16  paramKind    HTK parameter kind code (reference default 6)

followed by nSamples * (sampSize/4) big-endian float32 values, row-major.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

DEFAULT_SAMP_PERIOD = 100000  # 10 ms (matrix.h:420)
DEFAULT_PARAM_KIND = 6        # (matrix.h:422)

_HDR = struct.Struct(">iihh")


def read_htk(path: str) -> Tuple[np.ndarray, int, int]:
    """Read an HTK feature file -> (float32 array [n, d], sampPeriod, paramKind)."""
    with open(path, "rb") as f:
        data = f.read()
    n_samples, samp_period, samp_size, param_kind = _HDR.unpack_from(data, 0)
    cols = samp_size // 4
    mat = np.frombuffer(data, dtype=">f4", count=n_samples * cols, offset=_HDR.size)
    return (
        np.ascontiguousarray(mat.reshape(n_samples, cols).astype(np.float32)),
        samp_period,
        param_kind,
    )


def write_htk(
    path: str,
    mat: np.ndarray,
    samp_period: int = DEFAULT_SAMP_PERIOD,
    param_kind: int = DEFAULT_PARAM_KIND,
) -> None:
    mat = np.asarray(mat, dtype=np.float32)
    if mat.ndim != 2:
        raise ValueError("HTK feature matrix must be 2-D")
    with open(path, "wb") as f:
        f.write(_HDR.pack(mat.shape[0], samp_period, mat.shape[1] * 4, param_kind))
        f.write(mat.astype(">f4").tobytes())
