"""Neural-network weight / norm / window / phoneme-list loaders.

Copy of phnrec_tpu/io/weights.py (numpy-only host code, kept in step with it).

The reference stores each 2-layer MLP (input -> sigmoid hidden -> softmax out)
in two interchangeable on-disk forms (ref nn.cpp):

* Quicknet ASCII (`.weights` + `.norms`, nn.cpp:116-412):
    weigvec <nInp*nHid>  ...row-major [hid][inp] floats...
    weigvec <nHid*nOut>  ...row-major [out][hid]...
    biasvec <nHid> ...      biasvec <nOut> ...
  and norms:  vec <nInp> means...  vec <nInp> devs...   (devs = 1/stddev;
  input normalization is (x - mean) * dev, nn.cpp:702-716)

* `.nbin` binary cache (little-endian, nn.cpp:464-592): written next to the
  ASCII weights on first load; the shipped model packages contain ONLY .nbin.
    int32 nlayers (=2); int32 sizes[3] = {nInp, nHid, nOut};
    f32 W1[nHid16][nInp16]; f32 W2[nOut16][nHid16];
    f32 b1[nHid16]; f32 b2[nOut16]; f32 mean[nInp16]; f32 dev[nInp16]
  where n16 = n rounded up to a multiple of 4 floats (16 bytes, nn.cpp:633-640);
  padding entries are zero.  NOTE: the writer emits nHid16 rows for W1 /
  nOut16 rows for W2 (full padded matrices).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class MLPParams:
    """Unpadded parameters of one 2-layer MLP.

    w1: [n_hid, n_inp]  (hidden j pre-act = w1[j] . x + b1[j])
    w2: [n_out, n_hid]
    mean/dev: input normalization, applied as (x - mean) * dev.
    """

    w1: np.ndarray
    b1: np.ndarray
    w2: np.ndarray
    b2: np.ndarray
    mean: np.ndarray
    dev: np.ndarray

    @property
    def n_inp(self) -> int:
        return self.w1.shape[1]

    @property
    def n_hid(self) -> int:
        return self.w1.shape[0]

    @property
    def n_out(self) -> int:
        return self.w2.shape[0]


def _align4(n: int) -> int:
    # Align16(bytes)/4: round float count up to a multiple of 4 (nn.cpp:633-640)
    return (n + 3) & ~3


def load_nbin(path: str) -> MLPParams:
    with open(path, "rb") as f:
        data = f.read()
    nlayers, n_inp, n_hid, n_out = struct.unpack_from("<4i", data, 0)
    if nlayers != 2:
        raise ValueError(f"{path}: expected 2 layers, got {nlayers}")
    i16, h16, o16 = _align4(n_inp), _align4(n_hid), _align4(n_out)
    off = 16
    out: List[np.ndarray] = []
    for count in (h16 * i16, o16 * h16, h16, o16, i16, i16):
        arr = np.frombuffer(data, dtype="<f4", count=count, offset=off)
        out.append(arr.astype(np.float32))
        off += count * 4
    w1 = out[0].reshape(h16, i16)[:n_hid, :n_inp]
    w2 = out[1].reshape(o16, h16)[:n_out, :n_hid]
    return MLPParams(
        w1=np.ascontiguousarray(w1),
        b1=out[2][:n_hid].copy(),
        w2=np.ascontiguousarray(w2),
        b2=out[3][:n_out].copy(),
        mean=out[4][:n_inp].copy(),
        dev=out[5][:n_inp].copy(),
    )


def save_nbin(path: str, p: MLPParams) -> None:
    i16, h16, o16 = _align4(p.n_inp), _align4(p.n_hid), _align4(p.n_out)
    w1 = np.zeros((h16, i16), np.float32)
    w1[: p.n_hid, : p.n_inp] = p.w1
    w2 = np.zeros((o16, h16), np.float32)
    w2[: p.n_out, : p.n_hid] = p.w2

    def pad(v: np.ndarray, n: int, fill: float = 0.0) -> np.ndarray:
        out = np.full(n, fill, np.float32)
        out[: len(v)] = v
        return out

    with open(path, "wb") as f:
        f.write(struct.pack("<4i", 2, p.n_inp, p.n_hid, p.n_out))
        f.write(w1.astype("<f4").tobytes())
        f.write(w2.astype("<f4").tobytes())
        f.write(pad(p.b1, h16).astype("<f4").tobytes())
        f.write(pad(p.b2, o16).astype("<f4").tobytes())
        f.write(pad(p.mean, i16).astype("<f4").tobytes())
        # padded dev entries are 1.0 in ParseNorms (nn.cpp:340-348) but the
        # binary writer stores whatever is in the padded buffer; they are
        # never used, we write 0 like a fresh parse would leave weights.
        f.write(pad(p.dev, i16).astype("<f4").tobytes())


def _tokens(path: str) -> List[str]:
    with open(path, "r", encoding="latin-1") as f:
        return f.read().split()


def load_ascii_weights(path: str) -> MLPParams:
    """Parse a Quicknet ASCII `.weights` file (without norms)."""
    toks = _tokens(path)
    pos = 0

    def expect(tag: str) -> int:
        nonlocal pos
        if toks[pos] != tag:
            raise ValueError(f"{path}: expected {tag!r} at token {pos}")
        n = int(toks[pos + 1])
        pos += 2
        return n

    def take(n: int) -> np.ndarray:
        nonlocal pos
        arr = np.array(toks[pos : pos + n], dtype=np.float32)
        pos += n
        return arr

    n_ih = expect("weigvec")
    ih = take(n_ih)
    n_ho = expect("weigvec")
    ho = take(n_ho)
    n_hid = expect("biasvec")
    b1 = take(n_hid)
    n_out = expect("biasvec")
    b2 = take(n_out)
    n_inp = n_ih // n_hid
    return MLPParams(
        w1=ih.reshape(n_hid, n_inp),
        b1=b1,
        w2=ho.reshape(n_out, n_hid),
        b2=b2,
        mean=np.zeros(n_inp, np.float32),
        dev=np.ones(n_inp, np.float32),
    )


def load_ascii_norms(path: str, n_inp: int) -> "tuple[np.ndarray, np.ndarray]":
    toks = _tokens(path)
    if toks[0] != "vec":
        raise ValueError(f"{path}: expected 'vec'")
    n1 = int(toks[1])
    mean = np.array(toks[2 : 2 + n1], dtype=np.float32)[:n_inp]
    pos = 2 + n1
    if toks[pos] != "vec":
        raise ValueError(f"{path}: expected second 'vec'")
    n2 = int(toks[pos + 1])
    dev = np.array(toks[pos + 2 : pos + 2 + n2], dtype=np.float32)[:n_inp]
    return mean, dev


def load_net(weights_path: str, norms_path: Optional[str] = None,
             write_nbin_cache: bool = False) -> MLPParams:
    """Load an MLP the way NeuralNet::Load does (nn.cpp:594-621):

    try `<weights stem>.nbin` first; fall back to ASCII weights + norms
    (optionally writing the binary cache back, like the reference does).
    """
    stem, _ = os.path.splitext(weights_path)
    nbin = stem + ".nbin"
    if os.path.exists(nbin):
        return load_nbin(nbin)
    p = load_ascii_weights(weights_path)
    if norms_path and os.path.exists(norms_path):
        p.mean, p.dev = load_ascii_norms(norms_path, p.n_inp)
    if write_nbin_cache:
        try:
            save_nbin(nbin, p)
        except OSError:
            pass
    return p


def load_window(path: str, length: int) -> np.ndarray:
    """Load an LCRC band window file: `length` whitespace-separated floats
    (traps.cpp:549-570)."""
    vals = np.array(_tokens(path)[:length], dtype=np.float32)
    if len(vals) != length:
        raise ValueError(f"{path}: expected {length} values, got {len(vals)}")
    return vals


def load_phoneme_list(path: str) -> List[str]:
    """One phoneme per line; order defines NN output indexing
    (phndec.cpp:305-350)."""
    out = []
    with open(path, "r", encoding="latin-1") as f:
        for line in f:
            name = line.rstrip("\r\n")
            # fgets keeps the line; the reference strips only \r\n, so an
            # all-whitespace line would become an empty phoneme; skip blanks
            # at EOF only (files end with a newline per entry).
            if name != "":
                out.append(name)
    return out
