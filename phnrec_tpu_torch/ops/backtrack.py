"""Kernels D and D': the device backtrack (csrc/backtrack.cu) and its
committed-window form, each with its plain PyTorch version and its own
launch count.

Counterparts of phnrec_tpu/decoder/phnloop.py::_backtrack_device_impl
(D, frame0 = 0) and ::backtrack_device_committed (D').  History [T, B] (i8
winner, i32 entry frame, f32 score) and n_frames [B] -> (count [B] i32, phn
[B, Smax] i8, start [B, Smax] i16 when T < 2^15 else i32, alpha_end
[B, Smax] f32), segments in reverse time order and exactly 0 past each
row's count.  For D, n_frames lies in [1, T].  D' walks a retained window
(row i = global frame row_offset[b] + i, entry frames global) down to the
committed boundary frame0[b]: f0 = max(frame0 - row_offset, 0), entry
frames rebased to max(ent - row_offset, f0), starts window-relative;
n_frames (window-relative) lies in [0, T].
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from phnrec_tpu_torch.ops import _build

LAUNCHES = 0              # kernel D
COMMITTED_LAUNCHES = 0    # kernel D'

Segs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def start_dtype(T: int) -> torch.dtype:
    return torch.int16 if T < 2 ** 15 else torch.int32


def backtrack_plain(max_phn: torch.Tensor, ent: torch.Tensor,
                    alpha: torch.Tensor, n_frames: torch.Tensor,
                    smax: int) -> Segs:
    """The walk as a loop of torch ops over segment slots, on any device."""
    T, B = max_phn.shape
    dev = max_phn.device
    end = n_frames.to(device=dev, dtype=torch.int64)
    count = torch.zeros(B, dtype=torch.int32, device=dev)
    phn = torch.zeros((B, smax), dtype=torch.int8, device=dev)
    start = torch.zeros((B, smax), dtype=start_dtype(T), device=dev)
    alpha_end = torch.zeros((B, smax), dtype=torch.float32, device=dev)
    for k in range(smax):
        active = end > 0
        t = torch.clamp(end - 1, 0, T - 1)[None]
        st = ent.gather(0, t)[0]
        phn[:, k] = torch.where(active, max_phn.gather(0, t)[0], 0)
        start[:, k] = torch.where(active, st, 0).to(start.dtype)
        alpha_end[:, k] = torch.where(active, alpha.gather(0, t)[0], 0.0)
        count += active.to(torch.int32)
        end = torch.where(active, st.to(torch.int64), end)
    return count, phn, start, alpha_end


def backtrack_committed_plain(max_phn: torch.Tensor, ent: torch.Tensor,
                              alpha: torch.Tensor, n_frames: torch.Tensor,
                              frame0: torch.Tensor, row_offset: torch.Tensor,
                              smax: int) -> Segs:
    """D' as a loop of torch ops over segment slots, on any device: the
    entry frames rebased to window rows first, then JAX's walk with its
    stop at f0."""
    T, B = max_phn.shape
    dev = max_phn.device
    ro = row_offset.to(device=dev, dtype=torch.int32)
    f0 = torch.clamp(frame0.to(device=dev, dtype=torch.int32) - ro, min=0)
    ent_rel = torch.maximum(ent - ro[None, :], f0[None, :])
    end = n_frames.to(device=dev, dtype=torch.int32)
    count = torch.zeros(B, dtype=torch.int32, device=dev)
    phn = torch.zeros((B, smax), dtype=torch.int8, device=dev)
    start = torch.zeros((B, smax), dtype=start_dtype(T), device=dev)
    alpha_end = torch.zeros((B, smax), dtype=torch.float32, device=dev)
    for k in range(smax):
        active = end > f0
        t = torch.clamp(end - 1, 0, T - 1).long()[None]
        st = ent_rel.gather(0, t)[0]
        phn[:, k] = torch.where(active, max_phn.gather(0, t)[0], 0)
        start[:, k] = torch.where(active, st, 0).to(start.dtype)
        alpha_end[:, k] = torch.where(active, alpha.gather(0, t)[0], 0.0)
        count += active.to(torch.int32)
        end = torch.where(active, st, end)
    return count, phn, start, alpha_end


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of a kernel-D library's entry point."""
    fn = lib.phn_backtrack
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p] * 5
        fn.restype = ctypes.c_int
    return lib


def _lib():
    return bind(_build.load("backtrack"))


def launch(lib: ctypes.CDLL, max_phn, ent, alpha, n_frames, frame0,
           row_offset, smax: int) -> Segs:
    """Kernel D (frame0 and row_offset None) or D' of ``lib`` (None: the
    package's, built at first use) on the current stream; raises on what
    the kernel does not take, before any build."""
    device = _build.cuda_device(max_phn)
    if max_phn.dim() != 2:
        raise ValueError("History arrays must be [T, B]")
    T, B = max_phn.shape
    if T == 0 or smax <= 0:
        raise ValueError("empty History or no segment slots")
    _build.require(max_phn, "max_phn", torch.int8, (T, B), device)
    _build.require(ent, "ent", torch.int32, (T, B), device)
    _build.require(alpha, "alpha", torch.float32, (T, B), device)
    for t, name in ((n_frames, "n_frames"), (frame0, "frame0"),
                    (row_offset, "row_offset")):
        if t is not None:
            _build.require(t, name, torch.int32, (B,), device)
    sdt = start_dtype(T)
    count = torch.empty(B, dtype=torch.int32, device=device)
    phn = torch.empty((B, smax), dtype=torch.int8, device=device)
    start = torch.empty((B, smax), dtype=sdt, device=device)
    alpha_end = torch.empty((B, smax), dtype=torch.float32, device=device)
    if lib is None:
        lib = _lib()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    args = (max_phn.data_ptr(), ent.data_ptr(), alpha.data_ptr(),
            n_frames.data_ptr(), ptr(frame0), ptr(row_offset), T, B, smax,
            2 if sdt == torch.int16 else 4, count.data_ptr(), phn.data_ptr(),
            start.data_ptr(), alpha_end.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    # the launch goes to the thread's current device: enter ours only if
    # it is another
    if device.index == torch.cuda.current_device():
        err = lib.phn_backtrack(*args)
    else:
        with torch.cuda.device(device):
            err = lib.phn_backtrack(*args)
    _build.check(err, "backtrack")
    return count, phn, start, alpha_end


def backtrack(max_phn: torch.Tensor, ent: torch.Tensor, alpha: torch.Tensor,
              n_frames: torch.Tensor, smax: int) -> Segs:
    """Kernel D.  CPU tensors take the plain version; CUDA tensors launch
    the kernel, and anything the kernel does not take raises."""
    if max_phn.device.type == "cpu":
        return backtrack_plain(max_phn, ent, alpha, n_frames, smax)
    out = launch(None, max_phn, ent, alpha, n_frames, None, None, smax)
    global LAUNCHES
    LAUNCHES += 1
    return out


def backtrack_committed(max_phn: torch.Tensor, ent: torch.Tensor,
                        alpha: torch.Tensor, n_frames: torch.Tensor,
                        frame0: torch.Tensor, row_offset: torch.Tensor,
                        smax: int) -> Segs:
    """Kernel D'.  CPU tensors take the plain version; CUDA tensors launch
    the kernel, and anything the kernel does not take raises."""
    if max_phn.device.type == "cpu":
        return backtrack_committed_plain(max_phn, ent, alpha, n_frames,
                                         frame0, row_offset, smax)
    out = launch(None, max_phn, ent, alpha, n_frames, frame0, row_offset,
                 smax)
    global COMMITTED_LAUNCHES
    COMMITTED_LAUNCHES += 1
    return out
