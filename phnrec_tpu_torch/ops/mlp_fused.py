"""Kernel A: the fused 2-layer MLP forward (csrc/mlp_fused.cu) and its plain
PyTorch version.

Counterpart of phnrec_tpu/ops/pallas_mlp.py::mlp_forward_fused.  Shapes are
unpadded: x [N, n_inp], w1 [n_inp, n_hid], w2 [n_hid, n_out] (the 128-lane
padding of the Pallas kernel was for the TPU's tiling only).

The fused kernel keeps a block's normalised x tile in shared memory and
its output accumulators in registers, which bounds the widths it takes:
n_inp <= MAX_INP (480) and n_out <= MAX_OUT (256); the source exports the
same two numbers (phn_mlp_fused_max_inp, phn_mlp_fused_max_out) and the
wrapper holds them to its own.  Wider nets take the source's split path
(phn_mlp_fused_wide: the hidden layer through a scratch tensor in device
memory, transposed, then the output product and the row softmax), so the
kernel takes every width the plain version takes.

A band stack (the 3BT / 1BT systems' trap_bands band nets of one
topology) runs as one launch of the fused kernel with a band index
(``mlp_forward_bands``: a grid dimension over the nets, each block
advancing its pointers by its net's stride); its plain version is the
single net's, band by band.
"""

from __future__ import annotations

import ctypes

import torch

from phnrec_tpu_torch.ops import _build
from phnrec_tpu_torch.posteriors import fexp

LAUNCHES = 0
BAND_LAUNCHES = 0      # the launches of those that ran a band stack
WIDE_LAUNCHES = 0      # the launches of those that took the split path
MAX_INP = 480
MAX_OUT = 256


def mlp_forward_plain(x, mean, dev, w1, b1, w2, b2, *, fast: bool = True,
                      apply_softmax: bool = True) -> torch.Tensor:
    """The kernel's arithmetic in torch ops, on any device."""
    xn = (x - mean) * dev
    h = fexp.sigmoid(torch.matmul(xn, w1) + b1, fast)
    o = torch.matmul(h, w2) + b2
    return fexp.softmax(o, fast) if apply_softmax else o


def _lib():
    lib = _build.load("mlp_fused")
    fn = lib.phn_mlp_fused
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.phn_mlp_fused_wide.argtypes = [ctypes.c_void_p] * 9 + [
            ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.phn_mlp_fused_wide.restype = ctypes.c_int
        lib.phn_mlp_fused_wide_scratch.argtypes = [ctypes.c_longlong] + [
            ctypes.c_int] * 3
        lib.phn_mlp_fused_wide_scratch.restype = ctypes.c_longlong
        lib.phn_mlp_fused_bands.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.phn_mlp_fused_bands.restype = ctypes.c_int
        lib.phn_mlp_fused_max_out.restype = ctypes.c_int
        lib.phn_mlp_fused_max_inp.restype = ctypes.c_int
        limits = (lib.phn_mlp_fused_max_inp(), lib.phn_mlp_fused_max_out())
        if limits != (MAX_INP, MAX_OUT):
            raise RuntimeError(f"mlp_fused.cu takes n_inp, n_out up to "
                               f"{limits}, the wrapper {MAX_INP, MAX_OUT}")
    return lib


def fused_takes(n_inp: int, n_out: int) -> bool:
    """Whether the fused kernels (A and A') take a net's widths; wider
    nets take their split paths."""
    return n_inp <= MAX_INP and n_out <= MAX_OUT


def mlp_forward(x, mean, dev, w1, b1, w2, b2, *, fast: bool = True,
                apply_softmax: bool = True) -> torch.Tensor:
    """[N, n_inp] -> [N, n_out] float32.  CPU tensors take the plain
    version; CUDA tensors launch the kernel, and anything the kernel does
    not take raises."""
    if x.device.type == "cpu":
        return mlp_forward_plain(x, mean, dev, w1, b1, w2, b2, fast=fast,
                                 apply_softmax=apply_softmax)
    n_inp, n_hid = w1.shape
    n_out = w2.shape[1]
    device = _build.cuda_device(x)
    n = x.shape[0]
    f32 = torch.float32
    for t, name, shape in ((x, "x", (n, n_inp)), (mean, "mean", (n_inp,)),
                           (dev, "dev", (n_inp,)), (w1, "w1", (n_inp, n_hid)),
                           (b1, "b1", (n_hid,)), (w2, "w2", (n_hid, n_out)),
                           (b2, "b2", (n_out,))):
        _build.require(t, name, f32, shape, device)
    if n >= 2 ** 31 or (n > 2 ** 30 and not fused_takes(n_inp, n_out)):
        raise ValueError(f"{n} rows exceed the kernel's int32 row index")
    lib = _lib()
    out = torch.empty((n, n_out), dtype=f32, device=device)
    ptrs = [t.data_ptr() for t in (x, mean, dev, w1, b1, w2, b2, out)]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if fused_takes(n_inp, n_out):
            err = lib.phn_mlp_fused(*ptrs, n, n_inp, n_hid, n_out, int(fast),
                                    int(apply_softmax), stream)
        else:
            # xn and h transposed, the weights padded
            scratch = torch.empty(
                lib.phn_mlp_fused_wide_scratch(n, n_inp, n_hid, n_out),
                dtype=torch.uint8, device=device)
            err = lib.phn_mlp_fused_wide(*ptrs, scratch.data_ptr(), n, n_inp,
                                         n_hid, n_out, int(fast),
                                         int(apply_softmax), stream)
    _build.check(err, "mlp_fused")
    global LAUNCHES, WIDE_LAUNCHES
    LAUNCHES += 1
    WIDE_LAUNCHES += not fused_takes(n_inp, n_out)
    return out


def mlp_forward_bands_plain(x, mean, dev, w1, b1, w2, b2, *,
                            fast: bool = True,
                            apply_softmax: bool = True) -> torch.Tensor:
    """The band stack's arithmetic: the single net's plain version, band
    by band (x [NB, N, n_inp], the parameters stacked on a leading axis)
    -> [NB, N, n_out]."""
    return torch.stack([
        mlp_forward_plain(x[b], mean[b], dev[b], w1[b], b1[b], w2[b], b2[b],
                          fast=fast, apply_softmax=apply_softmax)
        for b in range(x.shape[0])])


def mlp_forward_bands(x, mean, dev, w1, b1, w2, b2, *, fast: bool = True,
                      apply_softmax: bool = True) -> torch.Tensor:
    """A stack of NB nets of one topology: x [NB, N, n_inp], mean and dev
    [NB, n_inp], w1 [NB, n_inp, n_hid], b1 [NB, n_hid], w2 [NB, n_hid,
    n_out], b2 [NB, n_out] -> [NB, N, n_out] float32.  CPU tensors take
    the plain version; CUDA tensors launch the band-indexed kernel once
    (fused widths only), and anything it does not take raises."""
    if x.device.type == "cpu":
        return mlp_forward_bands_plain(x, mean, dev, w1, b1, w2, b2,
                                       fast=fast, apply_softmax=apply_softmax)
    device = _build.cuda_device(x)
    nb, n, n_inp = x.shape
    n_hid, n_out = w1.shape[2], w2.shape[2]
    if not fused_takes(n_inp, n_out) or nb > 65535:
        raise ValueError(f"the band-indexed kernel takes n_inp <= {MAX_INP}, "
                         f"n_out <= {MAX_OUT} and at most 65,535 nets, not "
                         f"{nb} x {n_inp}->{n_hid}->{n_out}")
    f32 = torch.float32
    for t, name, shape in (
            (x, "x", (nb, n, n_inp)), (mean, "mean", (nb, n_inp)),
            (dev, "dev", (nb, n_inp)), (w1, "w1", (nb, n_inp, n_hid)),
            (b1, "b1", (nb, n_hid)), (w2, "w2", (nb, n_hid, n_out)),
            (b2, "b2", (nb, n_out))):
        _build.require(t, name, f32, shape, device)
    if n >= 2 ** 31:
        raise ValueError(f"{n} rows exceed the kernel's int32 row index")
    lib = _lib()
    out = torch.empty((nb, n, n_out), dtype=f32, device=device)
    ptrs = [t.data_ptr() for t in (x, mean, dev, w1, b1, w2, b2, out)]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.phn_mlp_fused_bands(*ptrs, nb, n, n_inp, n_hid, n_out,
                                      int(fast), int(apply_softmax), stream)
    _build.check(err, "mlp_fused")
    global LAUNCHES, BAND_LAUNCHES
    LAUNCHES += 1
    BAND_LAUNCHES += 1
    return out
