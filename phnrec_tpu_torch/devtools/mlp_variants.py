"""Compare variants of csrc/mlp_fused.cu on one CUDA card.

    python3 -m phnrec_tpu_torch.devtools.mlp_variants REF.cu [VARIANT.cu ...]

Builds every source given (all at once, with the package's nvcc flags, into
build/phnrec_tpu_torch/variants/), loads each through its C entry point
``phn_mlp_fused`` and, on synthetic packages at the CZ and EN shapes:

* holds each variant's outputs to the first source's with ``torch.equal``
  (a register-tiled kernel that keeps the fmaf chains is bit-equal) and to
  the plain version within chip_smoke.py's tolerances, at row counts that
  fill no row tile and at odd widths;
* times all of them in turns (first to last, then last to first) at 65,536
  rows for the band net and the merger of both packages and at 512 rows for
  band0, and prints cuBLAS's two bare products beside them.

One JSON line per build, check and timing.  With no variant it times the
reference alone.  The times of the designs tried for kernel A in PERF.md
come from this script on edited copies of the source.
"""

from __future__ import annotations

import ctypes
import json
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
from phnrec_tpu_torch.ops import _build, mlp_fused
from phnrec_tpu_torch.pipeline import SpeechRec

TOL_SOFTMAX, TOL_LOGITS = 2e-5, 1e-4      # chip_smoke.py's
ROWS = (1, 37, 130, 512, 8192 + 5, 65536 + 37)
ODD_SHAPES = ((7, 6, 4), (20, 16, 9), (55, 33, 12), (165, 70, 138),
              (39, 1501, 183), (100, 257, 256), (480, 130, 200))


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
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
    spill = sum(int(m) for m in re.findall(r"(\d+) bytes spill stores", log))
    print(json.dumps({"build": tag, "source": str(src),
                      "seconds": time.perf_counter() - t,
                      "kernels": len(regs), "registers": sorted(set(regs)),
                      "spill_bytes": spill}), flush=True)
    lib = ctypes.CDLL(str(so))
    lib.phn_mlp_fused.argtypes = [ctypes.c_void_p] * 8 + \
        [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.phn_mlp_fused.restype = ctypes.c_int
    return lib


def call(lib, x, net, fast=True, smx=True):
    out = torch.empty((x.shape[0], net.n_out), dtype=torch.float32,
                      device=x.device)
    err = lib.phn_mlp_fused(
        x.data_ptr(), net.mean.data_ptr(), net.dev.data_ptr(),
        net.w1.data_ptr(), net.b1.data_ptr(), net.w2.data_ptr(),
        net.b2.data_ptr(), out.data_ptr(), x.shape[0], net.n_inp, net.n_hid,
        net.n_out, int(fast), int(smx),
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "phn_mlp_fused")
    return out


def plain(x, net, fast, smx):
    return mlp_fused.mlp_forward_plain(x, net.mean, net.dev, net.w1, net.b1,
                                       net.w2, net.b2, fast=fast,
                                       apply_softmax=smx)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cases(dev):
    """(label, net, x, fast, softmax) over the packages' nets and the odd
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
        nets[f"{n_inp}-{n_hid}-{n_out}"] = SimpleNamespace(
            n_inp=n_inp, n_hid=n_hid, n_out=n_out, mean=t(n_inp),
            dev=t(n_inp).abs() + 0.5, w1=t(n_inp, n_hid, scale=n_inp ** -0.5),
            b1=t(n_hid, scale=0.1), w2=t(n_hid, n_out, scale=n_hid ** -0.5),
            b2=t(n_out, scale=0.1))
    xs = {k: (t(max(ROWS), m.n_inp) / m.dev + m.mean).contiguous()
          for k, m in nets.items()}
    return nets, xs


def main(argv) -> int:
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
    nets, xs = cases(dev)

    for name, lib in variants:
        bad, worst = [], {True: 0.0, False: 0.0}
        for label, net in nets.items():
            modes = [(f, s) for f in (True, False) for s in (True, False)] \
                if label == "cz.band0" else [(True, True), (False, False)]
            for rows in ROWS:
                x = xs[label][:rows]
                for fast, smx in modes:
                    got, want = call(lib, x, net, fast, smx), \
                        call(ref, x, net, fast, smx)
                    err = float((got - plain(x, net, fast, smx)).abs().max())
                    worst[smx] = max(worst[smx], err)
                    if not (torch.equal(got, want) and err <=
                            (TOL_SOFTMAX if smx else TOL_LOGITS)):
                        bad.append([label, rows, fast, smx, err])
        print(json.dumps({"check": name, "against": ref_name,
                          "bit_equal_and_within_tolerance": not bad,
                          "bad": bad[:10], "max_err_softmax": worst[True],
                          "max_err_logits": worst[False]}), flush=True)

    timed = [(k, 65536) for k in ("cz.band0", "cz.merger", "en.band0",
                                  "en.merger")] + \
        [("cz.band0", 512), ("en.band0", 512)]
    ms = {name: {} for name in libs}
    for name in [*libs, *reversed(libs)]:
        for label, rows in timed:
            x = xs[label][:rows]
            ms[name].setdefault(f"{label}.{rows}", []).append(round(cuda_ms(
                lambda: call(libs[name], x, nets[label])), 4))
    for name, t in ms.items():
        print(json.dumps({"time_ms": name, "cz_three_nets": [
            round(2 * a + b, 4) for a, b in zip(t["cz.band0.65536"],
                                                t["cz.merger.65536"])],
            **t}), flush=True)
    for label, rows in timed[:4]:
        x, net = xs[label][:rows], nets[label]
        print(json.dumps({"sgemm_pair_ms": label, "ms": cuda_ms(
            lambda: torch.matmul(torch.matmul(x, net.w1), net.w2))}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
