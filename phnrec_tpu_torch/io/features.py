"""Full HTK feature-file toolbox — the STKLib/fileio.C equivalent.

Copy of phnrec_tpu/io/features.py (numpy-only host code, kept in step with
it).

The core pipeline reads/writes plain float HTK files through io/htk.py
(matrix.h semantics, what phnrec itself uses).  This module adds the rest
of what the bundled STK toolkit supports (ReadHTKFeatures,
fileio.C:354-720), for interchange with HTK/STK tool chains:

  * parameter-kind codec (base names + _E _N _D _A _C _Z _K _0 _V _T
    qualifiers; common.h:320-343, ReadParmKind/ParmKind2Str)
  * compressed (_C) files: scale/bias float vectors after the header,
    int16 samples, x = (s + B) / A (fileio.C:144-170,445-462; writer uses
    the HTK constants A = 2*32767/(max-min), B = (max+min)*32767/(max-min))
  * CRC qualifier _K: a 2-byte checksum trails the data (accepted and
    stripped on read; not validated, as in STK)
  * frame-range selection via the HTK ``name[start,end]`` filename syntax
    (fileio.C:373-440,489-500)
  * boundary frame extension ext_left/ext_right (fileio.C:575-606)
  * delta/acceleration/third-order derivative computation with HTK's
    regression formula and boundary clamping (fileio.C:627-668)
  * sentence cepstral mean normalization when the target kind requests _Z
    and the source lacks it (fileio.C:608-625)
  * CMN / CVN / VarScale sidecar files (<CEPSNORM> <KIND> header,
    <MEAN>/<VARIANCE>/<VARSCALE> n + values; variance applied as
    1/sqrt(v), varscale as sqrt(v); ReadCepsNormFile, fileio.C)

Everything is host-side NumPy: this is file preparation, not the device
compute path.
"""

from __future__ import annotations

import os
import re
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# base parameter kinds (common.h:320-332)
BASE_KINDS = ["WAVEFORM", "LPC", "LPREFC", "LPCEPSTRA", "LPDELCEP", "IREFC",
              "MFCC", "FBANK", "MELSPEC", "USER", "DISCRETE", "PLP", "ANON"]
# qualifier letters in bit order (common.h:334-343)
QUALIFIERS = "ENDACZK0VT"
PARAMKIND_E = 0o100
PARAMKIND_N = 0o200
PARAMKIND_D = 0o400
PARAMKIND_A = 0o1000
PARAMKIND_C = 0o2000
PARAMKIND_Z = 0o4000
PARAMKIND_K = 0o10000
PARAMKIND_0 = 0o20000
PARAMKIND_V = 0o40000
PARAMKIND_T = 0o100000

_HDR = struct.Struct(">iihh")


def parse_param_kind(s: str) -> int:
    """'MFCC_0_D_A' -> kind code (ReadParmKind, common.C)."""
    parts = s.upper().split("_")
    try:
        kind = BASE_KINDS.index(parts[0])
    except ValueError:
        raise ValueError(f"unknown parameter kind {parts[0]!r}")
    for q in parts[1:]:
        if len(q) != 1 or q not in QUALIFIERS:
            raise ValueError(f"unknown parameter-kind qualifier {q!r}")
        kind |= PARAMKIND_E << QUALIFIERS.index(q)
    return kind


def param_kind_to_str(kind: int) -> str:
    base = kind & 0o77
    if base >= len(BASE_KINDS):
        raise ValueError(f"invalid parameter kind {kind}")
    out = BASE_KINDS[base]
    for i, q in enumerate(QUALIFIERS):
        if kind & (PARAMKIND_E << i):
            out += "_" + q
    return out


def _parse_range(path: str) -> Tuple[str, Optional[int], Optional[int]]:
    m = re.match(r"^(.*)\[(\d+),(\d+)\]$", path)
    if not m:
        return path, None, None
    return m.group(1), int(m.group(2)), int(m.group(3))


def read_ceps_norm_file(path: str, kind: str, expect_param_kind: int,
                        n_coefs: int) -> np.ndarray:
    """kind in {'mean', 'variance', 'varscale'} -> application vector
    (variance -> 1/sqrt(v), varscale -> sqrt(v); ReadCepsNormFile)."""
    text = open(path).read().split()
    pos = 0
    if kind != "varscale":
        if text[0].upper() != "<CEPSNORM>":
            raise ValueError(f"<CEPSNORM> expected in {path}")
        got = parse_param_kind(text[1].strip("<>"))
        if got != expect_param_kind:
            raise ValueError(
                f"{path}: kind {param_kind_to_str(got)} does not match "
                f"expected {param_kind_to_str(expect_param_kind)}")
        pos = 2
    tag = {"mean": "<MEAN>", "variance": "<VARIANCE>",
           "varscale": "<VARSCALE>"}[kind]
    if text[pos].upper() != tag or int(text[pos + 1]) != n_coefs:
        raise ValueError(f"{tag} {n_coefs} ... expected in {path}")
    vals = np.asarray([float(v) for v in text[pos + 2 : pos + 2 + n_coefs]],
                      np.float64)
    if len(vals) != n_coefs:
        raise ValueError(f"unexpected end of {path}")
    if kind == "variance":
        return (1.0 / np.sqrt(vals)).astype(np.float32)
    if kind == "varscale":
        return np.sqrt(vals).astype(np.float32)
    return vals.astype(np.float32)


def write_ceps_norm_file(path: str, kind: str, param_kind: int,
                         values: Sequence[float]) -> None:
    """Inverse of read_ceps_norm_file (values as stored: raw mean /
    variance / varscale, BEFORE the sqrt transforms)."""
    tag = {"mean": "<MEAN>", "variance": "<VARIANCE>",
           "varscale": "<VARSCALE>"}[kind]
    with open(path, "w") as f:
        if kind != "varscale":
            f.write(f"<CEPSNORM> <{param_kind_to_str(param_kind)}>\n")
        f.write(f"{tag} {len(values)}\n")
        f.write(" ".join(f"{v:g}" for v in values) + "\n")


def write_features(path: str, mat: np.ndarray, samp_period: int = 100000,
                   param_kind: int = 9, compress: bool = False,
                   add_crc: bool = False) -> None:
    """Write an HTK feature file; with ``compress`` the _C form with HTK's
    A/B quantization (WriteHTKFeature + the constants in fileio.C:158)."""
    mat = np.asarray(mat, np.float32)
    n, w = mat.shape
    kind = param_kind
    with open(path, "wb") as f:
        if not compress:
            kind &= ~PARAMKIND_C
            if add_crc:
                kind |= PARAMKIND_K
            f.write(_HDR.pack(n, samp_period, w * 4, kind))
            data = mat.astype(">f4").tobytes()
            f.write(data)
        else:
            kind |= PARAMKIND_C
            if add_crc:
                kind |= PARAMKIND_K
            xmax = mat.max(axis=0)
            xmin = mat.min(axis=0)
            rng = np.maximum(xmax - xmin, 1e-10)
            A = (2.0 * 32767.0 / rng).astype(np.float32)
            B = ((xmax + xmin) * 32767.0 / rng).astype(np.float32)
            s = np.clip(np.round(mat * A - B), -32768, 32767).astype(">i2")
            # nSamples counts the A/B rows as 4 int16 "samples"
            f.write(_HDR.pack(n + 4, samp_period, w * 2, kind))
            f.write(A.astype(">f4").tobytes())
            f.write(B.astype(">f4").tobytes())
            data = s.tobytes()
            f.write(data)
        if add_crc:
            f.write(struct.pack(">H", _crc(data)))


def _crc(data: bytes) -> int:
    """HTK's 16-bit CRC over the sample data."""
    attr = 0xFFFF
    for byte in data:
        attr ^= byte << 8
        for _ in range(8):
            attr = ((attr << 1) ^ 0xA001) & 0xFFFF if attr & 0x8000 \
                else (attr << 1) & 0xFFFF
    return attr


_DERIV_WIN_DEFAULT = (2, 2, 2)


def _add_derivs(x: np.ndarray, order_have: int, order_want: int,
                win_lens: Sequence[int]) -> np.ndarray:
    """HTK regression derivatives with boundary clamping
    (fileio.C:627-668).  x is [T, coefs*(order_have+1)]."""
    T = x.shape[0]
    coefs = x.shape[1] // (order_have + 1)
    out = x
    for o in range(order_have, order_want):
        win = win_lens[o]
        norm = sum(2 * k * k for k in range(1, win + 1))
        src = out[:, o * coefs : (o + 1) * coefs]
        d = np.zeros_like(src)
        for k in range(1, win + 1):
            up = src[np.minimum(np.arange(T) + k, T - 1)]
            dn = src[np.maximum(np.arange(T) - k, 0)]
            d += k * (up - dn)
        out = np.concatenate([out, d / norm], axis=1)
    return out


def read_features(path: str, target_kind: Optional[int] = None,
                  deriv_order: int = 0,
                  deriv_win_lens: Sequence[int] = _DERIV_WIN_DEFAULT,
                  ext_left: int = 0, ext_right: int = 0,
                  cmn_file: Optional[str] = None,
                  cvn_file: Optional[str] = None,
                  cvg_file: Optional[str] = None
                  ) -> Tuple[np.ndarray, int, int]:
    """ReadHTKFeatures equivalent: -> (matrix [T, D], samp_period, kind).

    ``path`` may carry an HTK frame range suffix ``name[s,e]``.
    ``deriv_order``: total derivative orders wanted (0-3); existing
    orders in the file are honored.  ``target_kind`` with PARAMKIND_Z
    triggers sentence CMN when the source lacks _Z.
    """
    fname, frm, to = _parse_range(path)
    raw = open(fname, "rb").read()
    n, samp_period, samp_size, kind = _HDR.unpack_from(raw, 0)
    off = _HDR.size
    comp = bool(kind & PARAMKIND_C)
    if comp:
        w = samp_size // 2
        A = np.frombuffer(raw, ">f4", w, off).astype(np.float64)
        B = np.frombuffer(raw, ">f4", w, off + 4 * w).astype(np.float64)
        off += 8 * w
        n -= 4                             # A/B counted as 4 int16 rows
        s = np.frombuffer(raw, ">i2", n * w, off).reshape(n, w)
        mat = ((s + B) / A).astype(np.float32)
    else:
        w = samp_size // 4
        mat = np.frombuffer(raw, ">f4", n * w, off).reshape(n, w).astype(
            np.float32)
    kind &= ~(PARAMKIND_C | PARAMKIND_K)

    if frm is not None:
        if to >= n or frm > to:
            raise ValueError(f"frame range [{frm},{to}] out of 0..{n - 1}")
        ext = mat[max(frm - ext_left, 0) : min(to + 1 + ext_right, n)]
        pre = max(ext_left - frm, 0)
        post = max(to + 1 + ext_right - n, 0)
        mat = np.concatenate(
            [np.repeat(ext[:1], pre, axis=0), ext,
             np.repeat(ext[-1:], post, axis=0)], axis=0)
    elif ext_left or ext_right:
        mat = np.concatenate(
            [np.repeat(mat[:1], ext_left, axis=0), mat,
             np.repeat(mat[-1:], ext_right, axis=0)], axis=0)

    have = 3 if kind & PARAMKIND_T else 2 if kind & PARAMKIND_A else \
        1 if kind & PARAMKIND_D else 0
    coefs = mat.shape[1] // (have + 1)

    # sentence CMN over static coefficients (fileio.C:608-625)
    if (cmn_file is None and target_kind is not None
            and (target_kind & PARAMKIND_Z) and not (kind & PARAMKIND_Z)):
        mat = mat.copy()
        mat[:, :coefs] -= mat[:, :coefs].mean(axis=0)
        kind |= PARAMKIND_Z

    if deriv_order > have:
        mat = _add_derivs(mat, have, deriv_order, deriv_win_lens)
        have = deriv_order
    kind &= ~(PARAMKIND_D | PARAMKIND_A | PARAMKIND_T)
    kind |= (PARAMKIND_D | PARAMKIND_A | PARAMKIND_T) if have == 3 else \
        (PARAMKIND_D | PARAMKIND_A) if have == 2 else \
        PARAMKIND_D if have == 1 else 0

    if cmn_file is not None:
        cmn = read_ceps_norm_file(cmn_file, "mean", kind & ~PARAMKIND_Z,
                                  coefs)
        mat = mat.copy()
        mat[:, :coefs] -= cmn
        kind |= PARAMKIND_Z
    if cvn_file is not None:
        cvn = read_ceps_norm_file(cvn_file, "variance", kind, mat.shape[1])
        mat = mat * cvn
    if cvg_file is not None:
        cvg = read_ceps_norm_file(cvg_file, "varscale", -1, mat.shape[1])
        mat = mat * cvg
    return mat, samp_period, kind
