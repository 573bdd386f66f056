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

On the card each takes one of two designs (``plan``): a thread-block
cluster of c blocks an utterance with log_A's slices in shared memory
(``cluster_plan``), or, for graphs whose slice does not fit, one block an
utterance reading log_A through L2.  Each design has its own launch count.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from phnrec_tpu_torch.ops import _build

LAUNCHES = 0                 # kernel K, one block an utterance
ALIGN_LAUNCHES = 0           # kernel K', one block an utterance
CLUSTER_LAUNCHES = 0         # kernel K on a cluster
ALIGN_CLUSTER_LAUNCHES = 0   # kernel K' on a cluster

NEG_INF = -1e30       # train/fb.py's NEG_INF

CLUSTER_SIZES = (2, 3, 4, 5, 6, 7, 8, 16)

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


def cluster_plan(B: int, max_active: dict) -> int:
    """The cluster size for a bucket of B utterances: of the sizes of
    which the card holds a cluster (``max_active``: c -> the clusters of c
    blocks it holds at once, cudaOccupancyMaxActiveClusters at one block
    an SM, 0 where the graphs' slice does not fit), the one that takes the
    fewest waves of B clusters, then the largest; 0 where there is none
    (the one-block kernels)."""
    fits = [c for c in CLUSTER_SIZES if max_active.get(c, 0) > 0]
    if not fits:
        return 0
    return min(fits, key=lambda c: (-(-B // max_active[c]), -c))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of the training-scan library's entry points
    (kernels J, K and K'; the cluster designs where the library has
    them)."""
    if lib.phn_loop_fb.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.phn_loop_fb.argtypes = [vp, i, i, i, i, i, f, f, f, vp, vp, vp,
                                    vp, vp]
        lib.graph_fb.argtypes = [vp] * 6 + [i] * 3 + [vp] * 5
        lib.graph_align.argtypes = [vp] * 5 + [i] * 3 + [vp] * 5
        fns = [lib.phn_loop_fb, lib.graph_fb, lib.graph_align]
        if hasattr(lib, "phn_loop_fb_group"):
            lib.phn_loop_fb_group.argtypes = lib.phn_loop_fb.argtypes
            fns.append(lib.phn_loop_fb_group)
        if hasattr(lib, "graph_fb_cluster"):
            for fn in (lib.graph_fb_cluster, lib.graph_align_cluster):
                fn.argtypes = [vp] * 5 + [i] * 4 + [vp] * 4
                fns.append(fn)
            lib.trainfb_cluster_max_active.argtypes = [i, i, i]
            lib.trainfb_cluster_max_active.restype = ctypes.c_int
        for fn in fns:
            fn.restype = ctypes.c_int
        lib.trainfb_scratch_floats.argtypes = [i, i]
        lib.trainfb_scratch_floats.restype = ctypes.c_longlong
    return lib


def _lib():
    return bind(_build.load("trainfb"))


_ACTIVE: dict = {}


def max_active(lib: ctypes.CDLL, align: bool, S: int, device) -> dict:
    """c -> how many clusters of c blocks of K (or K', ``align``) at S
    states the card of ``device`` holds at once, from the library's
    cudaOccupancyMaxActiveClusters (0 where the slice does not fit);
    cached.  Raises where the query fails."""
    key = (lib._name, device.index, align, S)
    if key not in _ACTIVE:
        with torch.cuda.device(device):
            got = {c: int(lib.trainfb_cluster_max_active(int(align), S, c))
                   for c in CLUSTER_SIZES}
        if min(got.values()) < 0:
            raise RuntimeError(f"cudaOccupancyMaxActiveClusters: {got}")
        _ACTIVE[key] = got
    return _ACTIVE[key]


def plan(lib: ctypes.CDLL, align: bool, B: int, S: int, device) -> int:
    """The cluster size ``lib``'s K (K') takes for B utterances of S
    states on ``device``; 0: the one-block kernel."""
    if not hasattr(lib, "graph_fb_cluster"):
        return 0
    return cluster_plan(B, max_active(lib, align, S, device))


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
              n_frames, cluster=None) -> Graphs:
    """Launch kernel K of ``lib`` on CUDA tensors on clusters of
    ``cluster`` blocks (None: as ``plan`` says; 0: the one-block kernel);
    raises on anything it does not take; counts nothing."""
    device, B, T, S = _check(log_A, log_entry, log_exit, log_b, n_frames)
    c = plan(lib, False, B, S, device) if cluster is None else cluster
    alpha = torch.empty((B, T, S), dtype=torch.float32, device=device)
    beta = torch.empty_like(alpha)
    like = torch.empty(B, dtype=torch.float32, device=device)
    ins = [t.data_ptr() for t in (log_A, log_entry, log_exit, log_b,
                                  n_frames)]
    outs = [t.data_ptr() for t in (alpha, beta, like)]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if c:
            err = lib.graph_fb_cluster(*ins, B, T, S, c, *outs, stream)
        else:
            log_AT = log_A.transpose(1, 2).contiguous()
            scr = scratch(lib, B, S, device)
            err = lib.graph_fb(ins[0], log_AT.data_ptr(), *ins[1:], B, T, S,
                               *outs, None if scr is None else scr.data_ptr(),
                               stream)
    _build.check(err, f"graph_fb (cluster {c})")
    return alpha, beta, like


def launch_align(lib: ctypes.CDLL, log_A, log_entry, log_exit, log_b,
                 n_frames, cluster=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel K' of ``lib`` on CUDA tensors, as ``launch_fb``;
    raises on anything it does not take; counts nothing."""
    device, B, T, S = _check(log_A, log_entry, log_exit, log_b, n_frames)
    c = plan(lib, True, B, S, device) if cluster is None else cluster
    bps = torch.empty((B, T, S), dtype=torch.int32, device=device)
    states = torch.empty((B, T), dtype=torch.int32, device=device)
    like = torch.empty(B, dtype=torch.float32, device=device)
    ins = [t.data_ptr() for t in (log_A, log_entry, log_exit, log_b,
                                  n_frames)]
    outs = [t.data_ptr() for t in (bps, states, like)]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if c:
            err = lib.graph_align_cluster(*ins, B, T, S, c, *outs, stream)
        else:
            scr = scratch(lib, B, S, device)
            err = lib.graph_align(*ins, B, T, S, *outs,
                                  None if scr is None else scr.data_ptr(),
                                  stream)
    _build.check(err, f"graph_align (cluster {c})")
    return states, like


def graph_fb(log_A: torch.Tensor, log_entry: torch.Tensor,
             log_exit: torch.Tensor, log_b: torch.Tensor,
             n_frames: torch.Tensor) -> Graphs:
    """Kernel K over a bucket batch: CPU tensors take the plain version;
    CUDA tensors launch the kernel (one launch, both scans, on clusters
    where the plan finds a size), and anything the kernel does not take
    raises."""
    args = (log_A, log_entry, log_exit, log_b, n_frames)
    if log_b.device.type == "cpu":
        return graph_fb_plain(*args)
    device = _build.cuda_device(log_b)          # raises before any build
    lib = _lib()
    c = plan(lib, False, log_b.shape[0], log_b.shape[-1], device)
    out = launch_fb(lib, *args, cluster=c)
    global LAUNCHES, CLUSTER_LAUNCHES
    if c:
        CLUSTER_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out


def graph_align(log_A: torch.Tensor, log_entry: torch.Tensor,
                log_exit: torch.Tensor, log_b: torch.Tensor,
                n_frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K' over a bucket batch: CPU tensors take the plain version;
    CUDA tensors launch the kernel (one launch: scan, argmax and walk
    back; on clusters as K), and anything the kernel does not take
    raises."""
    args = (log_A, log_entry, log_exit, log_b, n_frames)
    if log_b.device.type == "cpu":
        return graph_align_plain(*args)
    device = _build.cuda_device(log_b)
    lib = _lib()
    c = plan(lib, True, log_b.shape[0], log_b.shape[-1], device)
    out = launch_align(lib, *args, cluster=c)
    global ALIGN_LAUNCHES, ALIGN_CLUSTER_LAUNCHES
    if c:
        ALIGN_CLUSTER_LAUNCHES += 1
    else:
        ALIGN_LAUNCHES += 1
    return out
