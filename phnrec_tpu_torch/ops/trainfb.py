"""Kernels K and K': the dense training graph's forward-backward and its
Viterbi alignment (csrc/trainfb.cu, which also holds kernel J), each with
its plain PyTorch version and its own launch count.

Counterparts of phnrec_tpu/train/fb.py::forward_backward (scans :111 and
:123) and ::viterbi_align (scans :153 and :168), over a bucket batch:
log_A [B, S, S], log_entry / log_exit [B, S], log_b [B, T, S], n_frames [B]
(int32).  Frames at t >= n_frames[b] keep row b's carry and emit NEG_INF
(-1e30) rows (states -1).

* K: -> (log_alpha [B, T, S], log_beta [B, T, S], log_like [B]); each lse
  as jax.scipy.special.logsumexp takes it (the max shift, 0 where the max
  is not finite), so the unreachable pad states of train.graph.pad_graph
  (LOG_0 = -1e10 columns over -1e30 alphas) give JAX's finite values, not
  NaN.  The kernel sums its exps in its own order: a tolerance.
* K': -> (states [B, T] int32, log_like [B]); adds and compares only, the
  first (smallest) source index on ties, as jnp.argmax: bit-equal.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from phnrec_tpu_torch.ops import _build

LAUNCHES = 0          # kernel K
ALIGN_LAUNCHES = 0    # kernel K'

NEG_INF = -1e30       # train/fb.py's NEG_INF

Graphs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _f32(v: float) -> float:
    """``v`` rounded to float32, so torch's scalar arithmetic and the
    kernel's see the same number."""
    return float(np.float32(v))


def _live(n_frames: torch.Tensor, t: int) -> torch.Tensor:
    return (t < n_frames)[:, None]


def graph_fb_plain(log_A: torch.Tensor, log_entry: torch.Tensor,
                   log_exit: torch.Tensor, log_b: torch.Tensor,
                   n_frames: torch.Tensor) -> Graphs:
    """Kernel K's scans as Python loops of torch ops over frames, on any
    device."""
    B, T, S = log_b.shape
    n = n_frames.to(device=log_b.device, dtype=torch.int64)
    kw = dict(dtype=torch.float32, device=log_b.device)
    neg = torch.full((B, S), NEG_INF, **kw)
    alphas = torch.empty((B, T, S), **kw)
    betas = torch.empty((B, T, S), **kw)
    alpha = neg
    for t in range(T):
        prop = log_entry if t == 0 else torch.logsumexp(
            alpha[:, :, None] + log_A, dim=1)
        new = prop + log_b[:, t]
        live = _live(n, t)
        alpha = torch.where(live, new, alpha)
        alphas[:, t] = torch.where(live, new, neg)
    like = torch.logsumexp(alpha + log_exit, dim=1)
    beta = neg
    for t in range(T - 1, -1, -1):
        b_next = log_b[:, min(t + 1, T - 1)]
        last = (t == n - 1)[:, None]
        inner = (t < n - 1)[:, None]
        if bool(inner.any()):
            prop = torch.logsumexp(log_A + (b_next + beta)[:, None, :], dim=2)
            beta = torch.where(inner, prop, beta)
        beta = torch.where(last, log_exit, beta)
        betas[:, t] = torch.where(_live(n, t), beta, neg)
    return alphas, betas, like


def graph_align_plain(log_A: torch.Tensor, log_entry: torch.Tensor,
                      log_exit: torch.Tensor, log_b: torch.Tensor,
                      n_frames: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K''s max-plus scan with back-pointers, final argmax and walk
    back as Python loops of torch ops, on any device."""
    B, T, S = log_b.shape
    dev = log_b.device
    n = n_frames.to(device=dev, dtype=torch.int64)
    alpha = torch.full((B, S), NEG_INF, dtype=torch.float32, device=dev)
    bps = torch.zeros((B, T, S), dtype=torch.int64, device=dev)
    for t in range(T):
        scores = alpha[:, :, None] + log_A           # [B, from, to]
        bp = torch.argmax(scores, dim=1)             # the first max
        prop = scores.gather(1, bp[:, None, :])[:, 0]
        new = (log_entry if t == 0 else prop) + log_b[:, t]
        live = _live(n, t)
        alpha = torch.where(live, new, alpha)
        bps[:, t] = torch.where(live, bp, 0)
    final = alpha + log_exit
    last = torch.argmax(final, dim=1)
    like = final.gather(1, last[:, None])[:, 0]
    states = torch.empty((B, T), dtype=torch.int64, device=dev)
    carry = last
    for t in range(T - 1, -1, -1):
        cur = torch.where(t == n - 1, last, carry)
        states[:, t] = torch.where(t < n, cur, -1)
        carry = torch.where(t <= n - 1,
                            bps[:, t].gather(1, cur[:, None])[:, 0], cur)
    return states.to(torch.int32), like


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of the training-scan library's entry points
    (kernels J, K and K')."""
    if lib.phn_loop_fb.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.phn_loop_fb.argtypes = [vp, i, i, i, i, i, f, f, f, vp, vp, vp,
                                    vp, vp]
        lib.graph_fb.argtypes = [vp] * 6 + [i] * 3 + [vp] * 5
        lib.graph_align.argtypes = [vp] * 5 + [i] * 3 + [vp] * 5
        for fn in (lib.phn_loop_fb, lib.graph_fb, lib.graph_align):
            fn.restype = ctypes.c_int
        lib.trainfb_scratch_floats.argtypes = [i, i]
        lib.trainfb_scratch_floats.restype = ctypes.c_longlong
    return lib


def _lib():
    return bind(_build.load("trainfb"))


def scratch(lib: ctypes.CDLL, B: int, width: int, device):
    """The device scratch of a launch whose carries (2 x ``width`` floats
    an utterance) do not fit in 48 KB of shared memory (the looped path),
    else None."""
    n = int(lib.trainfb_scratch_floats(B, width))
    return torch.empty(n, dtype=torch.float32, device=device) if n else None


def _check(log_A, log_entry, log_exit, log_b, n_frames):
    device = _build.cuda_device(log_b)
    if log_b.dim() != 3:
        raise ValueError("log_b must be [B, T, S]")
    B, T, S = log_b.shape
    if B * max(T, 1) * S >= 2 ** 62 or B * S * S >= 2 ** 62:
        raise ValueError("graphs too large")
    _build.require(log_A, "log_A", torch.float32, (B, S, S), device)
    _build.require(log_entry, "log_entry", torch.float32, (B, S), device)
    _build.require(log_exit, "log_exit", torch.float32, (B, S), device)
    _build.require(log_b, "log_b", torch.float32, (B, T, S), device)
    _build.require(n_frames, "n_frames", torch.int32, (B,), device)
    return device, B, T, S


def launch_fb(lib: ctypes.CDLL, log_A, log_entry, log_exit, log_b,
              n_frames) -> Graphs:
    """Launch kernel K of ``lib`` on CUDA tensors; raises on anything it
    does not take; counts nothing."""
    device, B, T, S = _check(log_A, log_entry, log_exit, log_b, n_frames)
    log_AT = log_A.transpose(1, 2).contiguous()
    alpha = torch.empty((B, T, S), dtype=torch.float32, device=device)
    beta = torch.empty_like(alpha)
    like = torch.empty(B, dtype=torch.float32, device=device)
    scr = scratch(lib, B, S, device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.graph_fb(
            log_A.data_ptr(), log_AT.data_ptr(), log_entry.data_ptr(),
            log_exit.data_ptr(), log_b.data_ptr(), n_frames.data_ptr(), B, T,
            S, alpha.data_ptr(), beta.data_ptr(), like.data_ptr(),
            None if scr is None else scr.data_ptr(), stream)
    _build.check(err, "graph_fb")
    return alpha, beta, like


def launch_align(lib: ctypes.CDLL, log_A, log_entry, log_exit, log_b,
                 n_frames) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel K' of ``lib`` on CUDA tensors; raises on anything it
    does not take; counts nothing."""
    device, B, T, S = _check(log_A, log_entry, log_exit, log_b, n_frames)
    bps = torch.empty((B, T, S), dtype=torch.int32, device=device)
    states = torch.empty((B, T), dtype=torch.int32, device=device)
    like = torch.empty(B, dtype=torch.float32, device=device)
    scr = scratch(lib, B, S, device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.graph_align(
            log_A.data_ptr(), log_entry.data_ptr(), log_exit.data_ptr(),
            log_b.data_ptr(), n_frames.data_ptr(), B, T, S, bps.data_ptr(),
            states.data_ptr(), like.data_ptr(),
            None if scr is None else scr.data_ptr(), stream)
    _build.check(err, "graph_align")
    return states, like


def graph_fb(log_A: torch.Tensor, log_entry: torch.Tensor,
             log_exit: torch.Tensor, log_b: torch.Tensor,
             n_frames: torch.Tensor) -> Graphs:
    """Kernel K over a bucket batch: CPU tensors take the plain version;
    CUDA tensors launch the kernel (one launch, both scans), and anything
    the kernel does not take raises."""
    args = (log_A, log_entry, log_exit, log_b, n_frames)
    if log_b.device.type == "cpu":
        return graph_fb_plain(*args)
    _build.cuda_device(log_b)          # raises before any build
    out = launch_fb(_lib(), *args)
    global LAUNCHES
    LAUNCHES += 1
    return out


def graph_align(log_A: torch.Tensor, log_entry: torch.Tensor,
                log_exit: torch.Tensor, log_b: torch.Tensor,
                n_frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K' over a bucket batch: CPU tensors take the plain version;
    CUDA tensors launch the kernel (one launch: scan, argmax and walk
    back), and anything the kernel does not take raises."""
    args = (log_A, log_entry, log_exit, log_b, n_frames)
    if log_b.device.type == "cpu":
        return graph_align_plain(*args)
    _build.cuda_device(log_b)
    out = launch_align(_lib(), *args)
    global ALIGN_LAUNCHES
    ALIGN_LAUNCHES += 1
    return out
