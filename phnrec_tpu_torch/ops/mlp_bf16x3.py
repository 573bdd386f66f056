"""Kernel A': the fused 2-layer MLP forward with bf16 tensor-core passes
(csrc/mlp_bf16x3.cu) and its plain PyTorch version.

Counterpart of phnrec_tpu/ops/pallas_mlp.py::mlp_forward_fused at
Precision.HIGH (the Pallas kernel ``_kernel3`` with ``_split_bf16`` and
``_dot3``): the chain of kernel A, with each float32 GEMM taken as

    a @ b ~= a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi      (passes=3)
    a @ b ~= a_hi @ b_hi                                  (passes=1)

in float32 sums, where (hi, lo) = ``split_bf16``.  The weights are split
once by the caller (``split_weights``, as pallas_mlp.py:153-155 splits them
outside the grid) and zero-padded to the kernel's tiles: W1 to
[round16(n_inp), round128(n_hid)], W2 to [round128(n_hid), round16(n_out)].
Padded lanes hold zero in both halves, so they add nothing.  x, mean, dev,
b1 and b2 stay float32 and unpadded.

The fused kernel takes the widths kernel A's fused kernel takes (n_inp <=
480, n_out <= 256, ``mlp_fused.fused_takes``), and the wrapper holds the
limits the source exports to A's.  Wider nets take the source's split path
(phn_mlp_bf16x3_wide: xn and the hidden layer split once into bf16 halves
in a scratch tensor in device memory, then two products on wgmma with the
same passes), so every width is taken.

A band stack runs as one launch with a band index, as kernel A's does
(``mlp_forward_bf16x3_bands``; the split weights of each net stacked on a
leading axis, ``split_weights`` net by net).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from phnrec_tpu_torch.ops import _build, mlp_fused
from phnrec_tpu_torch.posteriors import fexp

LAUNCHES = 0
BAND_LAUNCHES = 0      # the launches of those that ran a band stack
WIDE_LAUNCHES = 0      # the launches of those that took the split path

K_TILE = 16      # the MMA depth
H_TILE = 128     # hidden-axis padding (a multiple of the kernel's chunk)
O_TILE = 16      # the MMA width


def _round(n: int, m: int) -> int:
    return -(-n // m) * m


def split_bf16(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 -> (hi, lo) bf16 with hi + lo == a to ~16 mantissa bits: hi
    rounds to nearest even, lo is the float32 residual a - hi, rounded the
    same way."""
    hi = a.to(torch.bfloat16)
    return hi, (a - hi.to(torch.float32)).to(torch.bfloat16)


def split_weights(w1: torch.Tensor, w2: torch.Tensor):
    """w1 [n_inp, n_hid], w2 [n_hid, n_out] float32 -> (w1_hi, w1_lo,
    w2_hi, w2_lo) bf16, zero-padded to the kernel's tiles."""
    n_inp, n_hid = w1.shape
    n_out = w2.shape[1]
    kp, hp, op = (_round(n_inp, K_TILE), _round(n_hid, H_TILE),
                  _round(n_out, O_TILE))
    p1 = torch.zeros((kp, hp), dtype=torch.float32, device=w1.device)
    p1[:n_inp, :n_hid] = w1
    p2 = torch.zeros((hp, op), dtype=torch.float32, device=w2.device)
    p2[:n_hid, :n_out] = w2
    return (*split_bf16(p1), *split_bf16(p2))


def _dot(a, b_hi, b_lo, passes: int) -> torch.Tensor:
    """``_dot3`` (passes=3) or the single pass, as float32 GEMMs of the
    bf16-valued operands: a product of two bf16 values is exact in
    float32, so only the order of the sums differs from the kernel's."""
    a_hi, a_lo = (t.to(torch.float32) for t in split_bf16(a))
    b_hi, b_lo = b_hi.to(torch.float32), b_lo.to(torch.float32)
    out = torch.matmul(a_hi, b_hi)
    if passes == 3:
        out = out + torch.matmul(a_hi, b_lo) + torch.matmul(a_lo, b_hi)
    return out


def _check_passes(passes: int) -> None:
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, not {passes}")


def mlp_forward_bf16x3_plain(x, mean, dev, w1_hi, w1_lo, b1, w2_hi, w2_lo,
                             b2, *, fast: bool = True,
                             apply_softmax: bool = True,
                             passes: int = 3) -> torch.Tensor:
    """The kernel's arithmetic in torch ops, on any device (TF32 off)."""
    _check_passes(passes)
    n_inp, n_hid, n_out = x.shape[1], b1.shape[0], b2.shape[0]
    xn = (x - mean) * dev
    h = fexp.sigmoid(_dot(xn, w1_hi[:n_inp, :n_hid], w1_lo[:n_inp, :n_hid],
                          passes) + b1, fast)
    o = _dot(h, w2_hi[:n_hid, :n_out], w2_lo[:n_hid, :n_out], passes) + b2
    return fexp.softmax(o, fast) if apply_softmax else o


def _lib():
    lib = _build.load("mlp_bf16x3")
    fn = lib.phn_mlp_bf16x3
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.phn_mlp_bf16x3_wide.argtypes = [ctypes.c_void_p] * 11 + [
            ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.phn_mlp_bf16x3_wide.restype = ctypes.c_int
        lib.phn_mlp_bf16x3_wide_scratch.argtypes = [ctypes.c_longlong] + [
            ctypes.c_int] * 3
        lib.phn_mlp_bf16x3_wide_scratch.restype = ctypes.c_longlong
        lib.phn_mlp_bf16x3_bands.argtypes = [ctypes.c_void_p] * 10 + [
            ctypes.c_int] * 8 + [ctypes.c_void_p]
        lib.phn_mlp_bf16x3_bands.restype = ctypes.c_int
        lib.phn_mlp_bf16x3_max_out.restype = ctypes.c_int
        lib.phn_mlp_bf16x3_max_inp.restype = ctypes.c_int
        limits = (lib.phn_mlp_bf16x3_max_inp(), lib.phn_mlp_bf16x3_max_out())
        if limits != (mlp_fused.MAX_INP, mlp_fused.MAX_OUT):
            raise RuntimeError(
                f"mlp_bf16x3.cu takes n_inp, n_out up to {limits}, kernel A "
                f"{mlp_fused.MAX_INP, mlp_fused.MAX_OUT}")
    return lib


def mlp_forward_bf16x3(x, mean, dev, w1_hi, w1_lo, b1, w2_hi, w2_lo, b2, *,
                       fast: bool = True, apply_softmax: bool = True,
                       passes: int = 3) -> torch.Tensor:
    """[N, n_inp] -> [N, n_out] float32.  CPU tensors take the plain
    version; CUDA tensors launch the kernel, and anything the kernel does
    not take raises."""
    _check_passes(passes)
    if x.device.type == "cpu":
        return mlp_forward_bf16x3_plain(
            x, mean, dev, w1_hi, w1_lo, b1, w2_hi, w2_lo, b2, fast=fast,
            apply_softmax=apply_softmax, passes=passes)
    n, n_inp = x.shape
    n_hid, n_out = b1.shape[0], b2.shape[0]
    device = _build.cuda_device(x)
    kp, hp, op = (_round(n_inp, K_TILE), _round(n_hid, H_TILE),
                  _round(n_out, O_TILE))
    f32, bf16 = torch.float32, torch.bfloat16
    for t, name, dt, shape in (
            (x, "x", f32, (n, n_inp)), (mean, "mean", f32, (n_inp,)),
            (dev, "dev", f32, (n_inp,)), (w1_hi, "w1_hi", bf16, (kp, hp)),
            (w1_lo, "w1_lo", bf16, (kp, hp)), (b1, "b1", f32, (n_hid,)),
            (w2_hi, "w2_hi", bf16, (hp, op)),
            (w2_lo, "w2_lo", bf16, (hp, op)), (b2, "b2", f32, (n_out,))):
        _build.require(t, name, dt, shape, device)
    if n >= 2 ** 31:
        raise ValueError(f"{n} rows exceed the kernel's int32 row index")
    for t, name in ((w1_hi, "w1_hi"), (w1_lo, "w1_lo"), (w2_hi, "w2_hi"),
                    (w2_lo, "w2_lo")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    lib = _lib()
    out = torch.empty((n, n_out), dtype=f32, device=device)
    ptrs = [t.data_ptr() for t in (x, mean, dev, w1_hi, w1_lo, b1, w2_hi,
                                   w2_lo, b2, out)]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if mlp_fused.fused_takes(n_inp, n_out):
            err = lib.phn_mlp_bf16x3(*ptrs, n, n_inp, n_hid, n_out,
                                     int(fast), int(apply_softmax), passes,
                                     stream)
        else:
            # the bf16 halves of xn and of the hidden layer
            scratch = torch.empty(
                lib.phn_mlp_bf16x3_wide_scratch(n, n_inp, n_hid, passes),
                dtype=torch.uint8, device=device)
            err = lib.phn_mlp_bf16x3_wide(*ptrs, scratch.data_ptr(), n,
                                          n_inp, n_hid, n_out, int(fast),
                                          int(apply_softmax), passes, stream)
    _build.check(err, "mlp_bf16x3")
    global LAUNCHES, WIDE_LAUNCHES
    LAUNCHES += 1
    WIDE_LAUNCHES += not mlp_fused.fused_takes(n_inp, n_out)
    return out


def mlp_forward_bf16x3_bands_plain(x, mean, dev, w1_hi, w1_lo, b1, w2_hi,
                                   w2_lo, b2, *, fast: bool = True,
                                   apply_softmax: bool = True,
                                   passes: int = 3) -> torch.Tensor:
    """The band stack's arithmetic: the single net's plain version, band
    by band -> [NB, N, n_out]."""
    return torch.stack([
        mlp_forward_bf16x3_plain(
            x[b], mean[b], dev[b], w1_hi[b], w1_lo[b], b1[b], w2_hi[b],
            w2_lo[b], b2[b], fast=fast, apply_softmax=apply_softmax,
            passes=passes) for b in range(x.shape[0])])


def mlp_forward_bf16x3_bands(x, mean, dev, w1_hi, w1_lo, b1, w2_hi, w2_lo,
                             b2, *, fast: bool = True,
                             apply_softmax: bool = True,
                             passes: int = 3) -> torch.Tensor:
    """A stack of NB nets of one topology: x [NB, N, n_inp], mean and dev
    [NB, n_inp], w1_hi/lo [NB, kp, hp], b1 [NB, n_hid], w2_hi/lo [NB, hp,
    op], b2 [NB, n_out] -> [NB, N, n_out] float32.  CPU tensors take the
    plain version; CUDA tensors launch the band-indexed kernel once (fused
    widths only), and anything it does not take raises."""
    _check_passes(passes)
    if x.device.type == "cpu":
        return mlp_forward_bf16x3_bands_plain(
            x, mean, dev, w1_hi, w1_lo, b1, w2_hi, w2_lo, b2, fast=fast,
            apply_softmax=apply_softmax, passes=passes)
    device = _build.cuda_device(x)
    nb, n, n_inp = x.shape
    n_hid, n_out = b1.shape[1], b2.shape[1]
    if not mlp_fused.fused_takes(n_inp, n_out) or nb > 65535:
        raise ValueError(
            f"the band-indexed kernel takes n_inp <= {mlp_fused.MAX_INP}, "
            f"n_out <= {mlp_fused.MAX_OUT} and at most 65,535 nets, not "
            f"{nb} x {n_inp}->{n_hid}->{n_out}")
    kp, hp, op = (_round(n_inp, K_TILE), _round(n_hid, H_TILE),
                  _round(n_out, O_TILE))
    f32, bf16 = torch.float32, torch.bfloat16
    for t, name, dt, shape in (
            (x, "x", f32, (nb, n, n_inp)), (mean, "mean", f32, (nb, n_inp)),
            (dev, "dev", f32, (nb, n_inp)),
            (w1_hi, "w1_hi", bf16, (nb, kp, hp)),
            (w1_lo, "w1_lo", bf16, (nb, kp, hp)),
            (b1, "b1", f32, (nb, n_hid)),
            (w2_hi, "w2_hi", bf16, (nb, hp, op)),
            (w2_lo, "w2_lo", bf16, (nb, hp, op)),
            (b2, "b2", f32, (nb, n_out))):
        _build.require(t, name, dt, shape, device)
    if n >= 2 ** 31:
        raise ValueError(f"{n} rows exceed the kernel's int32 row index")
    for t, name in ((w1_hi, "w1_hi"), (w1_lo, "w1_lo"), (w2_hi, "w2_hi"),
                    (w2_lo, "w2_lo")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    lib = _lib()
    out = torch.empty((nb, n, n_out), dtype=f32, device=device)
    ptrs = [t.data_ptr() for t in (x, mean, dev, w1_hi, w1_lo, b1, w2_hi,
                                   w2_lo, b2, out)]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.phn_mlp_bf16x3_bands(*ptrs, nb, n, n_inp, n_hid, n_out,
                                       int(fast), int(apply_softmax), passes,
                                       stream)
    _build.check(err, "mlp_bf16x3")
    global LAUNCHES, BAND_LAUNCHES
    LAUNCHES += 1
    BAND_LAUNCHES += 1
    return out
