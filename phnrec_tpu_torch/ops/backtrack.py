"""Kernel D: the device backtrack (csrc/backtrack.cu) and its plain PyTorch
version.

Counterpart of phnrec_tpu/decoder/phnloop.py::_backtrack_device_impl with
frame0 = 0.  History [T, B] (i8 winner, i32 entry frame, f32 score) and
n_frames [B] -> (count [B] i32, phn [B, Smax] i8, start [B, Smax] i16 when
T < 2^15 else i32, alpha_end [B, Smax] f32), segments in reverse time
order and exactly 0 past each row's count.  n_frames must lie in [1, T].
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from phnrec_tpu_torch.ops import _build

LAUNCHES = 0

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


def _lib():
    lib = _build.load("backtrack")
    fn = lib.phn_backtrack
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p] * 5
        fn.restype = ctypes.c_int
    return lib


def backtrack(max_phn: torch.Tensor, ent: torch.Tensor, alpha: torch.Tensor,
              n_frames: torch.Tensor, smax: int) -> Segs:
    """CPU tensors take the plain version; CUDA tensors launch the kernel,
    and anything the kernel does not take raises."""
    if max_phn.device.type == "cpu":
        return backtrack_plain(max_phn, ent, alpha, n_frames, smax)
    device = _build.cuda_device(max_phn)
    if max_phn.dim() != 2:
        raise ValueError("History arrays must be [T, B]")
    T, B = max_phn.shape
    if T == 0 or smax <= 0:
        raise ValueError("empty History or no segment slots")
    _build.require(max_phn, "max_phn", torch.int8, (T, B), device)
    _build.require(ent, "ent", torch.int32, (T, B), device)
    _build.require(alpha, "alpha", torch.float32, (T, B), device)
    _build.require(n_frames, "n_frames", torch.int32, (B,), device)
    sdt = start_dtype(T)
    count = torch.empty(B, dtype=torch.int32, device=device)
    phn = torch.empty((B, smax), dtype=torch.int8, device=device)
    start = torch.empty((B, smax), dtype=sdt, device=device)
    alpha_end = torch.empty((B, smax), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _lib().phn_backtrack(
            max_phn.data_ptr(), ent.data_ptr(), alpha.data_ptr(),
            n_frames.data_ptr(), T, B, smax, 2 if sdt == torch.int16 else 4,
            count.data_ptr(), phn.data_ptr(), start.data_ptr(),
            alpha_end.data_ptr(), stream)
    _build.check(err, "backtrack")
    global LAUNCHES
    LAUNCHES += 1
    return count, phn, start, alpha_end
