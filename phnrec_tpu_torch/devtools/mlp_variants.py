"""Compare variants of a fused-MLP kernel source on one CUDA card.

    python3 -m phnrec_tpu_torch.devtools.mlp_variants [--wide] REF.cu [VARIANT.cu ...]

Builds every source given (all at once, with the package's nvcc flags, into
build/phnrec_tpu_torch/variants/) and prints each build's registers and
spills per kernel.  The entry point is the one the first source exports:
``phn_mlp_fused`` (kernel A, csrc/mlp_fused.cu) or ``phn_mlp_bf16x3``
(kernel A', csrc/mlp_bf16x3.cu).  On synthetic packages at the CZ and EN
shapes it

* holds each variant to the plain version within chip_smoke.py's
  tolerances, at row counts that fill no row tile and at odd widths, and
  compares it with the first source by ``torch.equal``.  For kernel A,
  whose register tiles keep the fmaf chains, bit-equality is required; for
  kernel A' it is reported only (another fold order sums otherwise), and
  both pass counts are held (3: the float32 tolerances, 1: the one-pass
  flip rule);
* times all of them in turns (first to last, then last to first) at 65,536
  rows for the band net and the merger of both packages and at 512 rows for
  band0 (kernel A' at 3 and 1 passes), and prints cuBLAS's bare products
  beside them: the two float32 products for A, the bf16 products at the
  padded shapes for A' (3 a layer at 3 passes, 1 at 1).

With ``--wide`` it takes the split paths instead (``phn_mlp_fused_wide``,
``phn_mlp_bf16x3_wide``: nets past n_inp 480 or n_out 256): seeded nets of
WIDE_SHAPES and MERGER_SHAPES (the 3BT and 1BT mergers) checked at ROWS up
to 9,005 and the mergers also at 128,037 rows, the same rules (kernel A's
split path bit-equal to the first source's), then each merger and the
widest WIDE_SHAPES net timed in turns at 128,000 (65,536) rows.

One JSON line per build, check and timing.  With no variant it checks and
times the reference alone.  The times of the designs tried for kernels A
and A' in PERF.md come from this script on edited copies of the sources.
"""

from __future__ import annotations

import ctypes
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from phnrec_tpu_torch import synth
from phnrec_tpu_torch.ops import _build, mlp_bf16x3, mlp_fused
from phnrec_tpu_torch.pipeline import SpeechRec

TOL_SOFTMAX, TOL_LOGITS = 2e-5, 1e-4      # chip_smoke.py's
ONE_PASS_FLIPS = 8                        # chip_smoke.py's
ROWS = (1, 37, 130, 512, 8192 + 5, 65536 + 37)
ODD_SHAPES = ((7, 6, 4), (20, 16, 9), (55, 33, 12), (165, 70, 138),
              (39, 1501, 183), (100, 257, 256), (480, 130, 200))


def ptxas_report(log: str) -> dict:
    """{kernel: [registers, spill store bytes]} from ptxas -v output."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            out.setdefault(name, [0, 0])[1] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, [0, 0])[0] = int(m.group(1))
    return out


def build(tag: str, src: Path):
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    so = out / f"{tag.replace(':', '_')}.so"
    t = time.perf_counter()
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(so), str(src)], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode:
        raise _build.KernelBuildError(f"{src}:\n{log}")
    print(json.dumps({"build": tag, "source": str(src),
                      "seconds": time.perf_counter() - t,
                      "ptxas": ptxas_report(log),
                      "warnings": [l for l in log.splitlines()
                                   if "arning" in l or "wgmma" in l]}),
          flush=True)
    return ctypes.CDLL(str(so))


class KernelA:
    """Entry point phn_mlp_fused: float32 weights."""
    symbol = "phn_mlp_fused"
    pass_counts = (0,)
    require_equal = True

    @staticmethod
    def bind(lib):
        fn = lib.phn_mlp_fused
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int

    @staticmethod
    def call(lib, x, net, fast=True, smx=True, passes=0):
        out = torch.empty((x.shape[0], net.n_out), dtype=torch.float32,
                          device=x.device)
        err = lib.phn_mlp_fused(
            x.data_ptr(), net.mean.data_ptr(), net.dev.data_ptr(),
            net.w1.data_ptr(), net.b1.data_ptr(), net.w2.data_ptr(),
            net.b2.data_ptr(), out.data_ptr(), x.shape[0], net.n_inp,
            net.n_hid, net.n_out, int(fast), int(smx),
            torch.cuda.current_stream().cuda_stream)
        _build.check(err, "phn_mlp_fused")
        return out

    @staticmethod
    def takes(lib, net):
        return True

    @staticmethod
    def plain(x, net, fast, smx, passes=0):
        return mlp_fused.mlp_forward_plain(
            x, net.mean, net.dev, net.w1, net.b1, net.w2, net.b2, fast=fast,
            apply_softmax=smx)

    @staticmethod
    def within(got, want, net, smx, passes=0):
        err = float((got - want).abs().max())
        return err, err <= (TOL_SOFTMAX if smx else TOL_LOGITS)

    @staticmethod
    def library_ms(x, net, passes=0):
        """cuBLAS's two float32 products of the net alone."""
        return cuda_ms(lambda: torch.matmul(torch.matmul(x, net.w1), net.w2))


class KernelA3:
    """Entry point phn_mlp_bf16x3: split, padded bf16 weights."""
    symbol = "phn_mlp_bf16x3"
    pass_counts = (3, 1)
    require_equal = False

    @staticmethod
    def bind(lib):
        fn = lib.phn_mlp_bf16x3
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.phn_mlp_bf16x3_max_inp.restype = ctypes.c_int
        lib.phn_mlp_bf16x3_max_out.restype = ctypes.c_int

    @staticmethod
    def takes(lib, net):
        """Whether the source takes the net's widths (an older source may
        take fewer than the wrapper)."""
        return net.n_inp <= lib.phn_mlp_bf16x3_max_inp() and \
            net.n_out <= lib.phn_mlp_bf16x3_max_out()

    @staticmethod
    def call(lib, x, net, fast=True, smx=True, passes=3):
        out = torch.empty((x.shape[0], net.n_out), dtype=torch.float32,
                          device=x.device)
        err = lib.phn_mlp_bf16x3(
            x.data_ptr(), net.mean.data_ptr(), net.dev.data_ptr(),
            net.w1_hi.data_ptr(), net.w1_lo.data_ptr(), net.b1.data_ptr(),
            net.w2_hi.data_ptr(), net.w2_lo.data_ptr(), net.b2.data_ptr(),
            out.data_ptr(), x.shape[0], net.n_inp, net.n_hid, net.n_out,
            int(fast), int(smx), passes,
            torch.cuda.current_stream().cuda_stream)
        _build.check(err, "phn_mlp_bf16x3")
        return out

    @staticmethod
    def plain(x, net, fast, smx, passes=3):
        return mlp_bf16x3.mlp_forward_bf16x3_plain(
            x, net.mean, net.dev, net.w1_hi, net.w1_lo, net.b1, net.w2_hi,
            net.w2_lo, net.b2, fast=fast, apply_softmax=smx, passes=passes)

    @staticmethod
    def within(got, want, net, smx, passes=3):
        """chip_smoke.py's rule: the float32 tolerances at 3 passes; at 1,
        logits within ONE_PASS_FLIPS bf16 flips of max|W2| and each
        probability within p (e^(2d) - 1) + TOL_SOFTMAX."""
        diff = (got - want).abs()
        err = float(diff.max())
        if passes == 3:
            return err, err <= (TOL_SOFTMAX if smx else TOL_LOGITS)
        flip = 2.0 ** -8 * float(net.w2.abs().max())
        if not smx:
            return err, err <= ONE_PASS_FLIPS * flip
        lim = want * math.expm1(2 * ONE_PASS_FLIPS * flip) + TOL_SOFTMAX
        return err, bool((diff <= lim).all())

    @staticmethod
    def library_ms(x, net, passes=3):
        """cuBLAS's bare bf16 products at the padded shapes: 3 a layer at 3
        passes (hi.hi, hi.lo, lo.hi), 1 at 1, bf16 out."""
        kp, hp = net.w1_hi.shape
        xp = torch.zeros((x.shape[0], kp), dtype=torch.bfloat16,
                         device=x.device)
        hpad = torch.zeros((x.shape[0], hp), dtype=torch.bfloat16,
                           device=x.device)

        def run():
            for a, bh, bl in ((xp, net.w1_hi, net.w1_lo),
                              (hpad, net.w2_hi, net.w2_lo)):
                torch.matmul(a, bh)
                if passes == 3:
                    torch.matmul(a, bl)
                    torch.matmul(a, bh)
        return cuda_ms(run)


class KernelAWide(KernelA):
    """Entry point phn_mlp_fused_wide: kernel A's split path."""
    symbol = "phn_mlp_fused_wide"

    @staticmethod
    def bind(lib):
        fn = lib.phn_mlp_fused_wide
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        if hasattr(lib, "phn_mlp_fused_wide_scratch"):
            lib.phn_mlp_fused_wide_scratch.argtypes = [ctypes.c_longlong] + \
                [ctypes.c_int] * 3
            lib.phn_mlp_fused_wide_scratch.restype = ctypes.c_longlong

    @staticmethod
    def call(lib, x, net, fast=True, smx=True, passes=0):
        """The scratch is the source's phn_mlp_fused_wide_scratch bytes
        where it exports that, else (the earlier designs) a float32 [N,
        n_hid] tensor."""
        n = x.shape[0]
        out = torch.empty((n, net.n_out), dtype=torch.float32,
                          device=x.device)
        size = (lib.phn_mlp_fused_wide_scratch(n, net.n_inp, net.n_hid,
                                               net.n_out)
                if hasattr(lib, "phn_mlp_fused_wide_scratch")
                else 4 * n * net.n_hid)
        scratch = torch.empty(size, dtype=torch.uint8, device=x.device)
        err = lib.phn_mlp_fused_wide(
            x.data_ptr(), net.mean.data_ptr(), net.dev.data_ptr(),
            net.w1.data_ptr(), net.b1.data_ptr(), net.w2.data_ptr(),
            net.b2.data_ptr(), out.data_ptr(), scratch.data_ptr(), n,
            net.n_inp, net.n_hid, net.n_out, int(fast), int(smx),
            torch.cuda.current_stream().cuda_stream)
        _build.check(err, "phn_mlp_fused_wide")
        return out


class KernelA3Wide(KernelA3):
    """Entry point phn_mlp_bf16x3_wide: kernel A''s split path.  Its
    scratch is the source's phn_mlp_bf16x3_wide_scratch bytes where it
    exports that, else (the first split path) a float32 [N, n_hid]
    tensor."""
    symbol = "phn_mlp_bf16x3_wide"

    @staticmethod
    def bind(lib):
        fn = lib.phn_mlp_bf16x3_wide
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        if hasattr(lib, "phn_mlp_bf16x3_wide_scratch"):
            lib.phn_mlp_bf16x3_wide_scratch.argtypes = [ctypes.c_longlong] + \
                [ctypes.c_int] * 3
            lib.phn_mlp_bf16x3_wide_scratch.restype = ctypes.c_longlong

    @staticmethod
    def takes(lib, net):
        return True

    @staticmethod
    def call(lib, x, net, fast=True, smx=True, passes=3):
        n = x.shape[0]
        out = torch.empty((n, net.n_out), dtype=torch.float32,
                          device=x.device)
        size = (lib.phn_mlp_bf16x3_wide_scratch(n, net.n_inp, net.n_hid,
                                                passes)
                if hasattr(lib, "phn_mlp_bf16x3_wide_scratch")
                else 4 * n * net.n_hid)
        scratch = torch.empty(size, dtype=torch.uint8, device=x.device)
        err = lib.phn_mlp_bf16x3_wide(
            x.data_ptr(), net.mean.data_ptr(), net.dev.data_ptr(),
            net.w1_hi.data_ptr(), net.w1_lo.data_ptr(), net.b1.data_ptr(),
            net.w2_hi.data_ptr(), net.w2_lo.data_ptr(), net.b2.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), n, net.n_inp, net.n_hid,
            net.n_out, int(fast), int(smx), passes,
            torch.cuda.current_stream().cuda_stream)
        _build.check(err, "phn_mlp_bf16x3_wide")
        return out


def kernel_ms(fn) -> dict:
    """Device ms by kernel of one call of ``fn`` (after a warm-up), from
    torch.profiler: the launches of a split path one by one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = re.sub(r"^void |\(anonymous namespace\)::", "",
                          e.name).split("(")[0]
            by[name] = by.get(name, 0.0) + (e.time_range.end -
                                            e.time_range.start) / 1e3
    return by


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cases(dev):
    """(label -> net, label -> x) over the packages' nets and the odd
    widths, x scaled so the normalised inputs are unit normal."""
    rng = np.random.default_rng(3)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to(dev)

    with tempfile.TemporaryDirectory() as tmp:
        est = {"cz": SpeechRec(synth.write_lcrc_package(
                   tmp + "/cz", "cz", seed=0), device=dev).estimator,
               "en": SpeechRec(synth.write_kws_package(
                   tmp + "/en", "en", seed=0), device=dev).estimator}
    nets = {f"{k}.{n}": m for k, e in est.items()
            for n, m in (("band0", e.band[0]), ("merger", e.merger))}
    for n_inp, n_hid, n_out in ODD_SHAPES:
        net = SimpleNamespace(
            n_inp=n_inp, n_hid=n_hid, n_out=n_out, mean=t(n_inp),
            dev=t(n_inp).abs() + 0.5, w1=t(n_inp, n_hid, scale=n_inp ** -0.5),
            b1=t(n_hid, scale=0.1), w2=t(n_hid, n_out, scale=n_hid ** -0.5),
            b2=t(n_out, scale=0.1))
        net.w1_hi, net.w1_lo, net.w2_hi, net.w2_lo = \
            mlp_bf16x3.split_weights(net.w1, net.w2)
        nets[f"{n_inp}-{n_hid}-{n_out}"] = net
    xs = {k: (t(max(ROWS), m.n_inp) / m.dev + m.mean).contiguous()
          for k, m in nets.items()}
    return nets, xs


# the split paths' nets: past n_inp 480 or n_out 256, and the 3BT / 1BT
# mergers (chip_smoke.py's WIDE_SHAPES and MERGER_SHAPES)
WIDE_SHAPES = ((500, 257, 138), (165, 200, 300), (500, 1500, 300),
               (600, 100, 200))
MERGER_SHAPES = ((1794, 1500, 138), (2070, 1500, 138))
WIDE_ROWS = (1, 37, 130, 512, 8192 + 5)
MERGER_ROWS = 128000


def wide_cases(dev):
    """(label -> net, label -> x) for the split paths: seeded nets of
    WIDE_SHAPES and MERGER_SHAPES, x of MERGER_ROWS + 37 rows (unit
    normal)."""
    g = torch.Generator(device=dev).manual_seed(5)

    def t(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    nets, xs = {}, {}
    for n_inp, n_hid, n_out in WIDE_SHAPES + MERGER_SHAPES:
        net = SimpleNamespace(
            n_inp=n_inp, n_hid=n_hid, n_out=n_out, mean=t(n_inp),
            dev=t(n_inp).abs() + 0.5, w1=t(n_inp, n_hid, scale=n_inp ** -0.5),
            b1=t(n_hid, scale=0.1), w2=t(n_hid, n_out, scale=n_hid ** -0.5),
            b2=t(n_out, scale=0.1))
        net.w1_hi, net.w1_lo, net.w2_hi, net.w2_lo = \
            mlp_bf16x3.split_weights(net.w1, net.w2)
        label = f"{n_inp}-{n_hid}-{n_out}"
        nets[label] = net
        xs[label] = t(MERGER_ROWS + 37, n_inp)
    return nets, xs


def main(argv) -> int:
    wide = bool(argv) and argv[0] == "--wide"
    argv = argv[1:] if wide else argv
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ERROR: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    # tagged by position: two sources may share a file name
    srcs = {f"{i}:{Path(a).stem}": Path(a) for i, a in enumerate(argv)}
    with ThreadPoolExecutor(len(srcs)) as ex:
        libs = dict(zip(srcs, ex.map(build, srcs, srcs.values())))
    (ref_name, ref), *variants = libs.items()
    kind = KernelA3 if hasattr(ref, KernelA3.symbol) else KernelA
    if wide:
        kind = KernelA3Wide if kind is KernelA3 else KernelAWide
    for lib in libs.values():
        kind.bind(lib)
    nets, xs = wide_cases(dev) if wide else cases(dev)
    rows_of = (lambda label: WIDE_ROWS + ((MERGER_ROWS + 37,) if label in (
        "1794-1500-138", "2070-1500-138") else ())) if wide else \
        (lambda label: ROWS)

    for name, lib in [(ref_name, ref), *variants]:
        bad, worst, unequal, taken = [], {}, 0, 0
        for label, net in nets.items():
            if not kind.takes(lib, net):
                continue
            taken += 1
            modes = [(f, s) for f in (True, False) for s in (True, False)] \
                if label in ("cz.band0", "1794-1500-138") else \
                [(True, True), (False, False)]
            for rows in rows_of(label):
                x = xs[label][:rows]
                for passes in kind.pass_counts:
                    for fast, smx in modes:
                        got = kind.call(lib, x, net, fast, smx, passes)
                        # compared with the first source where it takes
                        # the net
                        same = not kind.takes(ref, net) or torch.equal(
                            got, kind.call(ref, x, net, fast, smx, passes))
                        err, ok = kind.within(
                            got, kind.plain(x, net, fast, smx, passes), net,
                            smx, passes)
                        key = f"passes{passes}.{'softmax' if smx else 'logits'}"
                        worst[key] = max(worst.get(key, 0.0), err)
                        unequal += not same
                        if not ok or not torch.isfinite(got).all() or (
                                kind.require_equal and not same):
                            bad.append([label, rows, passes, fast, smx, err])
        print(json.dumps({"check": name, "against": ref_name,
                          "within_tolerance": not bad, "bad": bad[:10],
                          "nets_taken": f"{taken} of {len(nets)}",
                          "cases_not_bit_equal": unequal,
                          "max_abs_err": worst}), flush=True)

    timed = [(k, 65536) for k in ("cz.band0", "cz.merger", "en.band0",
                                  "en.merger")] + \
        [("cz.band0", 512), ("en.band0", 512)]
    if wide:
        timed = [("1794-1500-138", MERGER_ROWS), ("2070-1500-138",
                                                  MERGER_ROWS),
                 ("500-1500-300", 65536)]
    ms = {name: {} for name in libs}
    for name in [*libs, *reversed(libs)]:
        for passes in kind.pass_counts:
            for label, rows in timed:
                x = xs[label][:rows]
                ms[name].setdefault(f"{label}.{rows}.p{passes}", []).append(
                    round(cuda_ms(lambda: kind.call(
                        libs[name], x, nets[label], passes=passes)), 4))
    for name, t in ms.items():
        three = {} if wide else {f"cz_three_nets.p{p}": [
            round(2 * a + b, 4) for a, b in zip(t[f"cz.band0.65536.p{p}"],
                                                t[f"cz.merger.65536.p{p}"])]
            for p in kind.pass_counts}
        print(json.dumps({"time_ms": name, **three, **t}), flush=True)
    if wide:
        x = xs[timed[0][0]][:timed[0][1]]
        for name, lib in libs.items():
            for passes in kind.pass_counts:
                print(json.dumps({"kernel_ms": name, "net": timed[0][0],
                                  "passes": passes, "ms": kernel_ms(
                                      lambda: kind.call(
                                          lib, x, nets[timed[0][0]],
                                          passes=passes))}), flush=True)
    for passes in kind.pass_counts:
        for label, rows in timed[:len(timed) if wide else 4]:
            print(json.dumps({"library_products_ms": label, "passes": passes,
                              "ms": kind.library_ms(xs[label][:rows],
                                                    nets[label], passes)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
