"""STK binary accumulator-file interchange.

Copy of phnrec_tpu/train/stk_accum.py (host code), reading into and
writing from the port's Accumulators (torch tensors).

Reads/writes the accumulator dump format of STK's
``ModelSet::WriteAccums`` / ``ReadAccums`` (STKLib/Models.cc:2768-2934)
so statistics gathered by the training pipeline (train/accum.py) round-trip with the HTK/STK toolchain's parallel
re-estimation flow (per-job dumps merged by a final update pass).

File layout (binary, little-endian, FLOAT = float32 as in the shipped
``DOUBLEPRECISION=0`` builds, STKLib/common.h:92-103):

  INT_32  totFrames
  FLOAT   totLogLike
  repeated macro blocks, each:
    ASCII   ~<t> "<name>"        t in {h,s,m,u,v,t} (WriteAccum,
                                 Models.cc:854-946: fprintf '~%c "%s"')
    INT_32  occurances           (see note below)
    payload by macro type, sub-structures in Scan order
            (Hmm::Scan Models.cc:1247: states first, then transition;
             State::Scan Models.cc:2045: weight accums first, then
             mixtures; Mixture::Scan Models.cc:2172: mean, variance):
      state (DiagC only):  per mixture: FLOAT num, FLOAT den weight accum
      mean:      (D+1) FLOAT  [sum gamma*x ..., gamma]  + UINT_32 nxfsa=0
      variance:  (2D+1) FLOAT [sum gamma*x^2 ..., sum gamma*x ..., gamma]
                 + UINT_32 nxfsa=0      (Models.cc:1764-1771 accum layout)
      transition: N*N FLOAT LOG-domain counts (NormalizeAccum
                 log-normalizes rows, Models.cc:1017-1040)
    (PDFObsVec states contribute nothing: State::Scan skips mixtures and
     WriteAccum's mt_state branch writes only for KID_DiagC.)

NOTE on ``occurances``: the reference writes ``sizeof(long)`` bytes
(Macro::mOccurances, Models.h:183) but reads ``INT_32`` — self-
consistent only on 32-bit builds (where the format originated).  This
module uses the 4-byte layout ReadAccums expects; pass ``occ_bytes=8``
to consume LP64 WriteAccums output.

phnrec_tpu writes one ``~h`` block per HMM (sub-structures anonymous),
matching the macro structure of parse_mmf model sets; ~s/~m/~u/~v/~t
blocks for shared macros are skipped on read (as ReadAccums skips
unknown macros by scanning to the next '~').
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

import torch

from phnrec_tpu_torch.io.mmf import LOG_0, ModelSet
from phnrec_tpu_torch.train.accum import Accumulators
from phnrec_tpu_torch.train.graph import ModelIndex


def write_stk_accums(path: str, models: ModelSet, index: ModelIndex,
                     acc: Accumulators, occ_bytes: int = 4) -> None:
    """Dump ``acc`` in STK WriteAccums layout, one ~h block per HMM in
    index order."""
    host = [None if a is None else a.detach().cpu().numpy().astype(
        np.float64) for a in acc]
    occ, sum_x, sum_xx, trans = host[:4]
    occ_fmt = "<i" if occ_bytes == 4 else "<q"

    with open(path, "wb") as f:
        f.write(struct.pack("<i", int(round(float(acc.n_frames)))))
        f.write(struct.pack("<f", float(acc.total_log_like)))
        for hid, name in enumerate(index.names):
            hmm = models.hmms[name]
            f.write(f'~h "{name}"'.encode("latin-1"))
            f.write(struct.pack(occ_fmt, 0))
            for p in range(hmm.n_states - 2):
                row = index.state_id(hid, p)
                if hmm.gmm_states[p] is None:
                    continue          # PDFObsVec: no mixture statistics
                m = int(index.gmm_nmix[row])
                # state weight accums (num, den) per mixture
                wa = np.zeros((m, 2), np.float32)
                wa[:, 0] = occ[row, :m]
                f.write(wa.tobytes())
                for mi in range(m):
                    g = occ[row, mi]
                    mean_acc = np.concatenate(
                        [sum_x[row, mi], [g]]).astype(np.float32)
                    f.write(mean_acc.tobytes())
                    f.write(struct.pack("<I", 0))          # nxfsa
                    var_acc = np.concatenate(
                        [sum_xx[row, mi], sum_x[row, mi],
                         [g]]).astype(np.float32)
                    f.write(var_acc.tobytes())
                    f.write(struct.pack("<I", 0))
            N = hmm.n_states
            t = trans[hid, :N, :N]
            logt = np.where(t > 0.0, np.log(np.maximum(t, 1e-300)),
                            LOG_0).astype(np.float32)
            f.write(logt.tobytes())


def read_stk_accums(path: str, models: ModelSet, index: ModelIndex,
                    weight: float = 1.0, occ_bytes: int = 4, device="cuda"
                    ) -> Tuple[Accumulators, int, float]:
    """Read an STK accumulator dump into an Accumulators pytree shaped by
    ``index``.  Returns (accumulators, tot_frames, tot_log_like);
    statistics are scaled by ``weight`` exactly as ReadAccums'
    ``faddfloat(mul_const=weight)`` does (Models.cc:990-1004).  Blocks
    for macros not present in ``index`` are skipped.  The accumulators
    land on ``device``."""
    data = open(path, "rb").read()
    pos = 0

    def take(n: int) -> bytes:
        nonlocal pos
        if pos + n > len(data):
            raise ValueError(f"truncated accumulator file {path!r}")
        out = data[pos:pos + n]
        pos += n
        return out

    tot_frames = struct.unpack("<i", take(4))[0]
    tot_log_like = struct.unpack("<f", take(4))[0]

    NS = index.n_model_states
    M = index.gmm_weights.shape[1] if index.gmm_weights is not None else 1
    has_gmm = index.gmm_weights is not None
    D = index.gmm_means.shape[2] if has_gmm else 0
    occ = np.zeros((NS, M), np.float64)
    sum_x = np.zeros((NS, M, D), np.float64) if has_gmm else None
    sum_xx = np.zeros((NS, M, D), np.float64) if has_gmm else None
    trans = np.zeros((index.n_hmms, index.max_states, index.max_states),
                     np.float64)
    name_to_hid = {n: i for i, n in enumerate(index.names)}
    occ_fmt = "<i" if occ_bytes == 4 else "<q"

    while pos < len(data):
        if data[pos:pos + 1] != b"~":
            raise ValueError(f"malformed accumulator file {path!r} at "
                             f"byte {pos}: expected '~'")
        t = data[pos + 1:pos + 2].decode("latin-1")
        if t not in "hsmuvt" or data[pos + 2:pos + 4] != b' "':
            raise ValueError(f"bad macro header at byte {pos}")
        pos += 4
        end = data.index(b'"', pos)
        name = data[pos:end].decode("latin-1")
        pos = end + 1
        take(occ_bytes)       # occurances (not tracked)
        if t != "h" or name not in name_to_hid:
            # skip to the next macro header, as ReadAccums does for
            # unknown macros (binary scan for '~<t> "')
            nxt = _find_next_header(data, pos)
            pos = nxt
            continue
        hid = name_to_hid[name]
        hmm = models.hmms[name]
        for p in range(hmm.n_states - 2):
            row = index.state_id(hid, p)
            if hmm.gmm_states[p] is None:
                continue
            m = int(index.gmm_nmix[row])
            wa = np.frombuffer(take(8 * m), "<f4").reshape(m, 2)
            occ[row, :m] += weight * wa[:, 0].astype(np.float64)
            for mi in range(m):
                mean_acc = np.frombuffer(take(4 * (D + 1)), "<f4")
                nxfsa = struct.unpack("<I", take(4))[0]
                if nxfsa:
                    raise ValueError("Xform stat accums not supported")
                var_acc = np.frombuffer(take(4 * (2 * D + 1)), "<f4")
                nxfsa = struct.unpack("<I", take(4))[0]
                if nxfsa:
                    raise ValueError("Xform stat accums not supported")
                sum_x[row, mi] += weight * mean_acc[:D].astype(np.float64)
                sum_xx[row, mi] += weight * var_acc[:D].astype(np.float64)
                # occupancy rides in three places (mean tail, variance
                # tail, weight accum); the weight accum is authoritative
                # for occ, matching STK's separate storage
        N = hmm.n_states
        logt = np.frombuffer(take(4 * N * N), "<f4").reshape(N, N)
        trans[hid, :N, :N] += weight * np.where(
            logt > LOG_0 / 2, np.exp(logt.astype(np.float64)), 0.0)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    acc = Accumulators(
        occ=dev(occ), sum_x=None if sum_x is None else dev(sum_x),
        sum_xx=None if sum_xx is None else dev(sum_xx), trans=dev(trans),
        n_frames=dev(weight * tot_frames),
        total_log_like=dev(weight * tot_log_like), n_utts=dev(0.0))
    return acc, tot_frames, tot_log_like


def _find_next_header(data: bytes, pos: int) -> int:
    """Scan for the next '~<t> "' macro header (ReadAccums skip loop,
    Models.cc:2838-2860)."""
    while True:
        nxt = data.find(b"~", pos)
        if nxt < 0:
            return len(data)
        if (len(data) >= nxt + 4
                and data[nxt + 1:nxt + 2] in b"hsmuvt"
                and data[nxt + 2:nxt + 4] == b' "'):
            return nxt
        pos = nxt + 1
