"""Kernel H: the device traceback over kernel G's records
(csrc/nettrace.cu) and its plain PyTorch version.

Counterpart of ``NetworkDecoder._traceback_batch``
(phnrec_tpu/decoder/stknet.py:668-746), a reverse ``lax.scan`` over
frames vmapped over rows.  One call walks B rows:

    records (kernel G's, [B, T, .]: in_am, ex_am, cm_am, entry_edge,
    entry_val, sink_val, cs_am), n_valid [B] i32, frame0 [B] i32 (the
    committed boundary, -1 for none), the network's ``EdgeTables.tensors``,
    the terminal sink's index
      -> (ok [B] bool, sink_edge [B] i32, sink_val [B] f32,
          edges [B, T] i32, vals [B, T] f32)

Per row, from the terminal sink's closure edge at the last valid frame,
one frame a step backwards: an in-model hop through ``in_am``, or an
entry hop that crosses the closure edge ``cm_am[t-1]`` (``entry_edge[0]``
at t = 0) into its source model's exit state.  ``edges[b, t]`` is the
crossed closure-edge id at frame t (-1 if none) and ``vals[b, t]`` the
entry value there (0.0 if none); crossings at or before ``frame0`` are
not emitted and stop the walk.  The kernel is equal to the plain version
in every output.  The ids of the records (in_am, ex_am, cm_am,
entry_edge, cs_am) are int32 or, all five alike, int16 (kernel E's records
and the serving window's): each width has its instance of the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from phnrec_tpu_torch.decoder.stknet import NEG
from phnrec_tpu_torch.ops import _build

LAUNCHES = 0

Walk = Tuple[torch.Tensor, ...]
NEEDS = ("in_am", "ex_am", "cm_am", "entry_edge", "entry_val", "sink_val",
         "cs_am")


def nettrace_plain(recs: Dict[str, torch.Tensor], n_valid: torch.Tensor,
                   frame0: torch.Tensor, tb: Dict[str, torch.Tensor],
                   terminal_sink: int) -> Walk:
    """The walk as a Python loop of torch ops over frames, all rows at
    once, on any device: every gather of the JAX step is made, and a -1
    index wraps to the last entry as there."""
    in_am, ex_am, cm_am = recs["in_am"], recs["ex_am"], recs["cm_am"]
    B, T = in_am.shape[:2]
    dev = in_am.device
    n_cm = max(tb["cm_w"].shape[0], 1)
    n_cs = tb["cs_w"].shape[0]
    in_entry = tb["in_entry"]
    in_m, in_s = tb["in_src_m"].long(), tb["in_src_s"].long()
    cm_src, ex_src = tb["cm_src"].long(), tb["ex_src"].long()
    nv, f0 = n_valid.long(), frame0.long()
    ar = torch.arange(B, device=dev)
    last = (nv - 1).clamp(0, max(T - 1, 0))
    ts = terminal_sink
    sink_edge = recs["cs_am"][ar, last, ts].to(torch.int32)
    sink_val = recs["sink_val"][ar, last, ts]
    ok = (nv > 0) & (sink_val > NEG / 2)
    if n_cs:
        e0 = sink_edge.long().clamp(0, n_cs - 1)
        model = torch.where(ok, tb["cs_src"].long()[e0], -1)
    else:
        model = torch.full((B,), -1, dtype=torch.int64, device=dev)
    state = torch.where(model >= 0,
                        ex_src[ex_am[ar, last, model.clamp(min=0)].long()],
                        0)
    active = ok & (model >= 0)
    edges = torch.full((B, T), -1, dtype=torch.int32, device=dev)
    vals = torch.zeros((B, T), dtype=torch.float32, device=dev)
    for t in range(T - 1, -1, -1):
        live = active & (t < nv) & (model >= 0)
        k = in_am[ar, t, state].long()
        is_entry = in_entry[k]
        m = in_m[k]
        ek = (recs["entry_edge"][ar, 0, m] if t == 0
              else cm_am[ar, t - 1, m]).long().clamp(0, n_cm - 1)
        src_model = cm_src[ek]
        res_state = ex_src[ex_am[ar, max(t - 1, 0),
                                 src_model.clamp(min=0)].long()]
        crossed = live & is_entry
        emit = crossed & (t > f0)
        edges[:, t] = torch.where(emit, ek, -1).to(torch.int32)
        vals[:, t] = torch.where(emit, recs["entry_val"][ar, t, m], 0.0)
        state = torch.where(live, torch.where(is_entry, res_state,
                                              in_s[k]), state)
        model = torch.where(crossed, src_model, model)
        active = active & ~(crossed & (src_model < 0)) & (t != 0) \
            & ~(crossed & (t <= f0))
    return ok, sink_edge, sink_val, edges, vals


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of a kernel-H library's entry point."""
    fn = lib.nettrace
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 10 + [ctypes.c_void_p] * 21
        fn.restype = ctypes.c_int
        for name in ("nettrace_global", "nettrace_i16",
                     "nettrace_global_i16"):
            if hasattr(lib, name):
                getattr(lib, name).argtypes = fn.argtypes
                getattr(lib, name).restype = ctypes.c_int
        if hasattr(lib, "nettrace_stage_frames"):
            lib.nettrace_stage_frames.argtypes = [ctypes.c_int] * 5
            lib.nettrace_stage_frames.restype = ctypes.c_int
    return lib


def _lib():
    return bind(_build.load("nettrace"))


def launch(lib: ctypes.CDLL, recs: Dict[str, torch.Tensor],
           n_valid: torch.Tensor, frame0: torch.Tensor,
           tb: Dict[str, torch.Tensor], terminal_sink: int,
           force_global: bool = False) -> Walk:
    """Launch the kernel of ``lib`` (a bound kernel-H library) on CUDA
    tensors; raises on anything it does not take.  ``force_global`` takes
    the device-memory path whatever the network.  Counts nothing."""
    device = _build.cuda_device(recs["in_am"])
    B, T, E = recs["in_am"].shape
    M, S = recs["ex_am"].shape[2], recs["cs_am"].shape[2]
    n_in, n_ex = tb["in_w"].shape[0], tb["ex_w"].shape[0]
    n_cm, n_cs = tb["cm_w"].shape[0], tb["cs_w"].shape[0]
    if T < 1 or min(E, M, n_in, n_ex, n_cm) < 1:
        raise ValueError("kernel H needs frames, states, models, in-model, "
                         "exit and closure edges")
    if not 0 <= terminal_sink < S:
        raise ValueError(f"terminal sink {terminal_sink} not in 0..{S - 1}")
    if B * T * max(E, M, S) >= 2 ** 31:
        raise ValueError("records too large for 32-bit offsets")
    ids = recs["in_am"].dtype
    if ids not in (torch.int32, torch.int16):
        raise TypeError(f"record ids are int32 or int16, not {ids}")
    for k in NEEDS:
        w = {"in_am": E, "sink_val": S, "cs_am": S}.get(k, M)
        dt = torch.float32 if k in ("entry_val", "sink_val") else ids
        _build.require(recs[k], k, dt, (B, T, w), device)
    _build.require(n_valid, "n_valid", torch.int32, (B,), device)
    _build.require(frame0, "frame0", torch.int32, (B,), device)
    for k, dt, n in (("in_entry", torch.bool, n_in),
                     ("in_src_m", torch.int32, n_in),
                     ("in_src_s", torch.int32, n_in),
                     ("cm_src", torch.int32, n_cm),
                     ("ex_src", torch.int32, n_ex),
                     ("cs_src", torch.int32, n_cs)):
        _build.require(tb[k], k, dt, (n,), device)
    ok = torch.empty(B, dtype=torch.bool, device=device)
    sink_edge = torch.empty(B, dtype=torch.int32, device=device)
    sink_val = torch.empty(B, dtype=torch.float32, device=device)
    edges = torch.empty((B, T), dtype=torch.int32, device=device)
    vals = torch.empty((B, T), dtype=torch.float32, device=device)
    if B == 0:
        return ok, sink_edge, sink_val, edges, vals
    args = (B, T, E, M, S, n_in, n_ex, n_cm, n_cs, int(terminal_sink),
            *(recs[k].data_ptr() for k in NEEDS), n_valid.data_ptr(),
            frame0.data_ptr(),
            *(tb[k].data_ptr() for k in ("in_entry", "in_src_m", "in_src_s",
                                         "cm_src", "ex_src", "cs_src")),
            ok.data_ptr(), sink_edge.data_ptr(), sink_val.data_ptr(),
            edges.data_ptr(), vals.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    entry = getattr(lib, ("nettrace_global" if force_global else "nettrace")
                    + ("_i16" if ids == torch.int16 else ""))
    # the launch goes to the thread's current device: enter ours only if
    # it is another
    if device.index == torch.cuda.current_device():
        err = entry(*args)
    else:
        with torch.cuda.device(device):
            err = entry(*args)
    _build.check(err, "nettrace")
    return ok, sink_edge, sink_val, edges, vals


def nettrace(recs: Dict[str, torch.Tensor], n_valid: torch.Tensor,
             frame0: torch.Tensor, tb: Dict[str, torch.Tensor],
             terminal_sink: int) -> Walk:
    """Walk every row back: CPU tensors take the plain version; CUDA
    tensors launch the kernel (one launch for all rows), and anything the
    kernel does not take raises."""
    args = (recs, n_valid, frame0, tb, terminal_sink)
    if recs["in_am"].device.type == "cpu":
        return nettrace_plain(*args)
    _build.cuda_device(recs["in_am"])      # raises before any build
    out = launch(_lib(), *args)
    global LAUNCHES
    LAUNCHES += 1
    return out
