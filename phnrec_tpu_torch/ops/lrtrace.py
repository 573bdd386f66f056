"""Kernel F: the LRTrace keyword-candidate scan (csrc/lrtrace.cu) and its
plain PyTorch version.

Counterpart of the JAX package's vmapped ``lax.scan`` of
``lrtrace_step_fn`` over a network block's sink records
(phnrec_tpu/multistream.py:1017-1036, phnrec_tpu/decoder/stknet.py:
1114-1177).  One call runs all F frames for n streams:

    state = six [n, K] tensors (last_lr, cand_lr f32; cand_start,
            cand_end, prev_end i32; dumped bool)
    sink_val [F, n, S] f32, sink_wt [F, n, S] i32 (kernel B's records),
    word_sinks [K] i32 columns, filler_sink column, n_dec, n_valid [n] i32
      -> (state', (rec1, rec2)), each rec a dict of [n, F, K] tensors
         emit (bool), start, end (i32), score (f32), new_estim (bool)

Frame f of stream b is global frame n_dec[b] + f and live while
f < n_valid[b].  ``improve_kwd_estim`` and ``keyword0_time_quirk`` are
LRTrace's two settings (``lrtrace_step_fn``; the serving defaults off and
on), template parameters of the kernel.  The plain version is the frame
loop of ``lrtrace_step_fn``; the kernel is equal to it in every field.
Past the 128 keywords one launch takes, the kernel runs in groups of 128,
with keyword 0's candidate end a frame passed on through an [n, F]
scratch tensor where the quirk needs it.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from phnrec_tpu_torch.decoder.stknet import NEG, lrtrace_step_fn
from phnrec_tpu_torch.ops import _build

LAUNCHES = 0

State = Tuple[torch.Tensor, ...]
Events = Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]
_FIELDS = ("emit", "start", "end", "score", "new_estim")
_DTYPES = (torch.bool, torch.int32, torch.int32, torch.float32, torch.bool)


def lrtrace_scan_plain(state: State, sink_val: torch.Tensor,
                       sink_wt: torch.Tensor, word_sinks: torch.Tensor,
                       filler_sink: int, n_dec: torch.Tensor,
                       n_valid: torch.Tensor, time_pruning: float,
                       score_pruning: float, improve_kwd_estim: bool = False,
                       keyword0_time_quirk: bool = True
                       ) -> Tuple[State, Events]:
    """The scan as a Python loop of torch ops over frames, on any
    device."""
    step = lrtrace_step_fn(time_pruning, score_pruning, improve_kwd_estim,
                           keyword0_time_quirk)
    F = sink_val.shape[0]
    ws = word_sinks.to(device=sink_val.device, dtype=torch.long)
    n_dec = n_dec.to(torch.int32)
    n_valid = n_valid.to(torch.int32)
    recs = ([], [])
    for i in range(F):
        state, out = step(state, (sink_val[i][:, ws],
                                  sink_val[i][:, filler_sink],
                                  sink_wt[i][:, ws].to(torch.int32),
                                  n_dec + i, n_valid > i))
        for acc, rec in zip(recs, out):
            acc.append(rec)
    return state, tuple({k: torch.stack([r[k] for r in acc], dim=1)
                         for k in _FIELDS} for acc in recs)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of a kernel-F library's entry points."""
    fn = lib.lrtrace_scan
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 23)
        fn.restype = ctypes.c_int
        lib.lrtrace_max_keywords.restype = ctypes.c_int
        if hasattr(lib, "lrtrace_scan_groups"):
            lib.lrtrace_scan_groups.argtypes = fn.argtypes[:-1] + [
                ctypes.c_void_p] * 2
            lib.lrtrace_scan_groups.restype = ctypes.c_int
        if hasattr(lib, "lrtrace_scan_settings"):
            lib.lrtrace_scan_settings.argtypes = fn.argtypes[:-1] + [
                ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
            lib.lrtrace_scan_settings.restype = ctypes.c_int
    return lib


def _lib():
    return bind(_build.load("lrtrace"))


def launch(lib: ctypes.CDLL, state: State, sink_val: torch.Tensor,
           sink_wt: torch.Tensor, word_sinks: torch.Tensor, filler_sink: int,
           n_dec: torch.Tensor, n_valid: torch.Tensor, time_pruning: float,
           score_pruning: float, improve_kwd_estim: bool = False,
           keyword0_time_quirk: bool = True) -> Tuple[State, Events]:
    """Launch the kernel of ``lib`` (a bound kernel-F library) on CUDA
    tensors; raises on anything it does not take.  Counts nothing.  An
    earlier source (devtools/scan_variants.py compares them), without the
    settings' entry point, takes the serving defaults through its
    ``lrtrace_scan`` / ``lrtrace_scan_groups``."""
    device = _build.cuda_device(sink_val)
    if sink_val.dim() != 3:
        raise ValueError("sink_val must be [F, n, S]")
    F, n, S = sink_val.shape
    K = word_sinks.shape[0]
    groups = K > lib.lrtrace_max_keywords()
    if K < 1 or not 0 <= filler_sink < S:
        raise ValueError(f"kernel F takes one keyword or more and a filler "
                         f"column below {S}")
    settings = hasattr(lib, "lrtrace_scan_settings")
    if groups and not settings and not hasattr(lib, "lrtrace_scan_groups"):
        raise ValueError(f"this kernel-F source takes at most "
                         f"{lib.lrtrace_max_keywords()} keywords")
    if not settings and (improve_kwd_estim or not keyword0_time_quirk):
        raise ValueError("this kernel-F source takes the serving defaults "
                         "only (improve_kwd_estim off, the quirk on)")
    if F * n * max(S, K) >= 2 ** 31:
        raise ValueError("block too large for 32-bit offsets")
    _build.require(sink_val, "sink_val", torch.float32, (F, n, S), device)
    _build.require(sink_wt, "sink_wt", torch.int32, (F, n, S), device)
    _build.require(word_sinks, "word_sinks", torch.int32, (K,), device)
    _build.require(n_dec, "n_dec", torch.int32, (n,), device)
    _build.require(n_valid, "n_valid", torch.int32, (n,), device)
    for name, t, dt in zip(
            ("last_lr", "cand_lr", "cand_start", "cand_end", "prev_end",
             "dumped"), state,
            (torch.float32,) * 2 + (torch.int32,) * 3 + (torch.bool,)):
        _build.require(t, name, dt, (n, K), device)
    out_state = tuple(torch.empty_like(t) for t in state)
    events = tuple(
        {k: torch.empty((n, F, K), dtype=dt, device=device)
         for k, dt in zip(_FIELDS, _DTYPES)} for _ in range(2))
    tp = float(time_pruning)
    # keyword 0's candidate end a frame, from the first group to the others
    quirk = bool(keyword0_time_quirk) and tp < 1e9
    end0 = (torch.empty((n, F), dtype=torch.int32, device=device)
            if groups and (quirk or not settings) else None)
    if settings:
        fn = lib.lrtrace_scan_settings
        tail = (None if end0 is None else end0.data_ptr(),
                int(bool(improve_kwd_estim)), int(quirk))
    else:
        fn = lib.lrtrace_scan_groups if groups else lib.lrtrace_scan
        tail = (end0.data_ptr(),) if groups else ()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            sink_val.data_ptr(), sink_wt.data_ptr(), word_sinks.data_ptr(),
            int(filler_sink), n_dec.data_ptr(), n_valid.data_ptr(),
            F, n, S, K, int(tp < 1e9), int(tp) if tp < 1e9 else 0,
            float(np.float32(score_pruning)), float(NEG / 2),
            *(t.data_ptr() for t in state),
            *(t.data_ptr() for t in out_state),
            *(ev[k].data_ptr() for ev in events for k in _FIELDS),
            *tail, stream)
    _build.check(err, "lrtrace")
    return out_state, events


def lrtrace_scan(state: State, sink_val: torch.Tensor, sink_wt: torch.Tensor,
                 word_sinks: torch.Tensor, filler_sink: int,
                 n_dec: torch.Tensor, n_valid: torch.Tensor,
                 time_pruning: float, score_pruning: float,
                 improve_kwd_estim: bool = False,
                 keyword0_time_quirk: bool = True) -> Tuple[State, Events]:
    """One block of frames: CPU tensors take the plain version; CUDA
    tensors launch the kernel (one launch for all F frames, or one a
    group of 128 keywords), and anything the kernel does not take
    raises."""
    args = (state, sink_val, sink_wt, word_sinks, filler_sink, n_dec,
            n_valid, time_pruning, score_pruning, improve_kwd_estim,
            keyword0_time_quirk)
    if sink_val.device.type == "cpu":
        return lrtrace_scan_plain(*args)
    _build.cuda_device(sink_val)       # raises before any build
    out = launch(_lib(), *args)
    global LAUNCHES
    LAUNCHES += 1
    return out
