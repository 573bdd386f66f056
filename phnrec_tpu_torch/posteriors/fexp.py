"""ICSI fast-exp emulation (deterministic), exact sigmoid/softmax alternatives.

Counterpart of phnrec_tpu/posteriors/fexp.py on torch tensors, and the
arithmetic that csrc/mlp_fused.cu repeats on the card.  The reference's
shipped builds enable NN_FAST_EXP (makefile_phnrec.lin:10): hidden sigmoids
and output softmaxes use the ICSI bit-trick exponential (fexp.h:14-21).  With
the constructed double's low word set to 0 it decodes exactly as

    t = trunc_sat_int32(A * y) + K;  e = (t >> 20) - 1023;  m = t & 0xFFFFF
    fexp(y) = 2^e * (1 + m * 2^-20)

The rules that pin this to phnrec_tpu's definition:

* ``A * y`` is one float32 multiply by A rounded to float32 (JAX's
  weak-typed multiply); a float64 product truncates differently.
* the int32 conversion saturates, as JAX's ``astype(int32)`` does; torch's
  own conversion does not, so the value is clamped first.  ``+ K`` wraps in
  int32.
* ``2^e`` is built exactly and is 0 for ``e <= -126`` (XLA on the CPU
  flushes there) and inf for ``e >= 128``.
"""

from __future__ import annotations

import numpy as np
import torch

_LN2 = 0.69314718055994530942
FEXP_A = 1048576 / _LN2            # fexp.h:14
FEXP_K = 1072693248 - 60801        # fexp.h:15,20

_INT32_MIN = -2 ** 31
_INT32_MAX = 2 ** 31 - 1
# the largest float32 below 2^31: clamping to it keeps the conversion exact
_F32_BELOW_2_31 = 2147483520.0


def _trunc_sat_int32(v: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 holding C's truncation saturated to int32."""
    t = torch.clamp(v, -2.0 ** 31, _F32_BELOW_2_31).to(torch.int64)
    return torch.where(v >= 2.0 ** 31, _INT32_MAX, t)


def pow2_int(e: torch.Tensor) -> torch.Tensor:
    """Exact float32 2^e for integer e: 0 for e <= -126, inf for e >= 128."""
    bits = ((e.clamp(-126, 128) + 127) << 23).to(torch.int32)
    p = bits.view(torch.float32)
    p = torch.where(e <= -126, 0.0, p)
    return torch.where(e >= 128, float("inf"), p)


def fexp(y: torch.Tensor) -> torch.Tensor:
    """Deterministic ICSI fast exp (low word = 0)."""
    a = torch.tensor(FEXP_A, dtype=torch.float32, device=y.device)
    t = _trunc_sat_int32(a * y.to(torch.float32)) + FEXP_K
    t = ((t - _INT32_MIN) & 0xFFFFFFFF) + _INT32_MIN      # int32 wrap
    e = (t >> 20) - 1023
    m = (t & 0xFFFFF).to(torch.float32) * (1.0 / 1048576.0)
    return pow2_int(e) * (1.0 + m)


def sigmoid(x: torch.Tensor, fast: bool = True) -> torch.Tensor:
    """1 / (1 + exp(-x)); fast variant matches fexp_sigmoid (fexp.h:33-38)."""
    if fast:
        return 1.0 / (1.0 + fexp(-x))
    return torch.sigmoid(x)


def softmax(x: torch.Tensor, fast: bool = True) -> torch.Tensor:
    """Max-subtracted softmax along the last axis (fexp.h:49-78)."""
    shifted = x - torch.amax(x, dim=-1, keepdim=True)
    e = fexp(shifted) if fast else torch.exp(shifted)
    return e / torch.sum(e, dim=-1, keepdim=True)


def fexp_reference_np(y: np.ndarray) -> np.ndarray:
    """NumPy oracle for fexp with low word 0 (testing only): builds the
    double the C macro constructs.  Copy of
    phnrec_tpu/posteriors/fexp.py::fexp_reference_np."""
    y = np.atleast_1d(np.asarray(y, dtype=np.float64))
    i = (FEXP_A * y).astype(np.int64).astype(np.int32) + FEXP_K
    bits = (i.astype(np.int64) & 0xFFFFFFFF) << 32
    return bits.view(np.float64)
