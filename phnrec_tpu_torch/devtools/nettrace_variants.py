"""Compare designs of kernel H (the STK-network traceback,
csrc/nettrace.cu) on one CUDA card, and take its wrapper's host work
apart.

    python3 -m phnrec_tpu_torch.devtools.nettrace_variants \\
        [--wrapper OLD_NETTRACE.py] [SOURCE.cu ...]

Without a source, the package's csrc/nettrace.cu.  Every source is built
(package nvcc flags, into build/phnrec_tpu_torch/variants/, registers and
spills printed).  A source's designs are its entry points: ``nettrace``
(the warp-per-row kernel streaming the records through shared memory,
where the network fits) and ``nettrace_global`` (the first design, a
thread per row with every load from device memory, which the source keeps
as its device-memory path); an earlier source has ``nettrace`` alone, e.g.
``git show 454cc23:phnrec_tpu_torch/csrc/nettrace.cu >
build/nettrace_v1.cu``.  Each design is held bit for bit to the plain
version (ops/nettrace.py::nettrace_plain, all five outputs) on kernel G's
records of the CZ stkint phoneme loop at B 256 x T 500 (ragged rows, and
frame0 >= 0 on every second row), the EN KWS net at B 8 x T 6,000 and
tie-heavy CZ observations at B 13 x T 200.  Then all designs are timed in
turns (first to last, then last to first) at B 256 x T 500 on the CZ loop
(every row whole) by both timers (``ms``: mlp_variants.cuda_ms,
chip_smoke.py's; ``held_ms``: scan_variants.held_ms), with the SM clock
under load and clocks a step (T steps a row), and at B 1 and 132 (one row,
one row an SM).  Last, the host's work of one call at that shape
(backtrack_variants.host_cost), whole and in parts: the decoder's
``_traceback_batch``, the wrapper ``nettrace``, its checks, its output
allocations, the stream and device lookups and the bare ctypes call, in
turns (medians of six); with ``--wrapper`` also that file's ``launch``
(an earlier ops/nettrace.py) beside the package's.
One JSON line per build, check and timing.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from phnrec_tpu_torch import synth
from phnrec_tpu_torch.decoder.stknet import OFF_BEAM
from phnrec_tpu_torch.devtools.backtrack_variants import host_cost
from phnrec_tpu_torch.devtools.mlp_variants import build, cuda_ms
from phnrec_tpu_torch.devtools.netstep_variants import sm_clock
from phnrec_tpu_torch.devtools.scan_variants import bit_equal, held_ms
from phnrec_tpu_torch.ops import _build, netscan, nettrace
from phnrec_tpu_torch.pipeline import SpeechRec


def _records(dec, dev, B, T, seed, ties=False, whole=False):
    """Kernel G's records of seeded observations, n_valid (ragged unless
    ``whole``) and frame0 (-1 on every row)."""
    rng = np.random.default_rng(seed)
    D = int(dec.c.obs_index.max()) + 1
    if ties:
        lp = -rng.integers(0, 8, (B, T, D)).astype(np.float32) / 4
    else:
        lp = np.log(rng.dirichlet(np.ones(D), size=(B, T))).astype(
            np.float32)
    obs = dec.state_observations(torch.from_numpy(lp).to(dev))
    nv = np.full(B, T) if whole else rng.integers(0, T + 1, B)
    nv[::5] = T
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)  # noqa
    recs = netscan.netscan(dec.init_carry(dev, B), obs, i32(np.zeros(B)),
                           i32(nv), torch.full((B,), float(OFF_BEAM),
                                               device=dev),
                           dec.edge_tables(dev))[1]
    return recs, i32(nv), i32(np.full(B, -1))


def _designs(tag, lib):
    """(name, entry point) of each design a built source has."""
    nettrace.bind(lib)
    out = [(f"{tag}:nettrace", lib.nettrace)]
    if hasattr(lib, "nettrace_global"):
        out.append((f"{tag}:nettrace_global", lib.nettrace_global))
    return out


def _call(entry, recs, nv, f0, tb, ts):
    """Launch ``entry`` (an entry point with the ``nettrace`` signature)
    through the package's launch."""
    class Lib:
        nettrace = entry
    return nettrace.launch(Lib, recs, nv, f0, tb, ts)


def _load_wrapper(path: str):
    spec = importlib.util.spec_from_file_location("nettrace_wrapper", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_parts(dec, recs, nv, f0, old=None) -> dict:
    """The host's microseconds in one call at these records: whole and in
    parts (host_cost's medians of 3)."""
    dev = recs["in_am"].device
    tb = dec.edge_tables(dev)
    ts = dec.c.terminal_sink
    lib = nettrace._lib()
    B, T, E = recs["in_am"].shape
    outs = [torch.empty(B, dtype=dt, device=dev) for dt in
            (torch.bool, torch.int32, torch.float32)] + [
        torch.empty((B, T), dtype=dt, device=dev)
        for dt in (torch.int32, torch.float32)]
    M, S = recs["ex_am"].shape[2], recs["cs_am"].shape[2]
    sizes = (B, T, E, M, S, tb["in_w"].shape[0], tb["ex_w"].shape[0],
             tb["cm_w"].shape[0], tb["cs_w"].shape[0], ts)
    ptrs = [recs[k].data_ptr() for k in nettrace.NEEDS] + [
        nv.data_ptr(), f0.data_ptr()] + [
        tb[k].data_ptr() for k in ("in_entry", "in_src_m", "in_src_s",
                                   "cm_src", "ex_src", "cs_src")] + [
        t.data_ptr() for t in outs]
    stream = torch.cuda.current_stream(dev).cuda_stream

    def checks():
        for k in nettrace.NEEDS:
            _build.require(recs[k], k, recs[k].dtype,
                           tuple(recs[k].shape), dev)
        for t in (nv, f0, *(tb[k] for k in ("in_entry", "in_src_m",
                                             "in_src_s", "cm_src", "ex_src",
                                             "cs_src"))):
            _build.require(t, "t", t.dtype, tuple(t.shape), dev)

    def allocs():
        return (torch.empty(B, dtype=torch.bool, device=dev),
                torch.empty(B, dtype=torch.int32, device=dev),
                torch.empty(B, dtype=torch.float32, device=dev),
                torch.empty((B, T), dtype=torch.int32, device=dev),
                torch.empty((B, T), dtype=torch.float32, device=dev))

    def device_ctx():
        with torch.cuda.device(dev):
            pass

    fns = {"traceback_batch": lambda: dec._traceback_batch(recs, nv),
           "wrapper": lambda: nettrace.nettrace(recs, nv, f0, tb, ts),
           "launch": lambda: nettrace.launch(lib, recs, nv, f0, tb, ts),
           "checks_15": checks, "allocs_5": allocs,
           "stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
           "device_ctx": device_ctx,
           "ctypes_call": lambda: lib.nettrace(*sizes, *ptrs, stream)}
    if old is not None:
        old_lib = old.bind(_build.load("nettrace"))
        fns["old_launch"] = lambda: old.launch(old_lib, recs, nv, f0, tb, ts)
    # in turns, first to last and back, three times: medians
    costs = {k: [] for k in fns}
    for _ in range(3):
        for k in [*fns, *reversed(fns)]:
            costs[k].append(host_cost(fns[k], 300)["host_us"])
    return {k: float(np.median(v)) for k, v in costs.items()}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("ERROR: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    old = None
    if "--wrapper" in argv:
        i = argv.index("--wrapper")
        old = _load_wrapper(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    sources = argv or [str(_build.CSRC / "nettrace.cu")]
    designs = []
    for i, src in enumerate(sources):
        designs += _designs(f"v{i}_{Path(src).stem}",
                            build(f"nettrace_v{i}", Path(src)))
    tmp = tempfile.mkdtemp()
    cz = SpeechRec(synth.write_stk_decode_package(
        os.path.join(tmp, "cz"), "cz", seed=0), device=dev)
    en = SpeechRec(synth.write_kws_package(
        os.path.join(tmp, "en"), "en", seed=0), device=dev)
    czd, end = cz.stk_decoder.decoder, en.stk_decoder.decoder
    cases = {"cz_256x500": (czd, _records(czd, dev, 256, 500, 1)),
             "en_kws_8x6000": (end, _records(end, dev, 8, 6000, 2)),
             "cz_ties_13x200": (czd, _records(czd, dev, 13, 200, 3,
                                              ties=True))}
    ok = True
    for name, (dec, (recs, nv, f0)) in cases.items():
        f0c = f0.clone()
        f0c[1::2] = torch.randint(0, recs["in_am"].shape[1],
                                  f0c[1::2].shape, device=dev,
                                  generator=torch.Generator(dev)
                                  .manual_seed(5), dtype=torch.int32)
        for frame0 in (f0, f0c):
            args = (recs, nv, frame0, dec.edge_tables(dev),
                    dec.c.terminal_sink)
            want = nettrace.nettrace_plain(*args)
            for tag, entry in designs:
                got = _call(entry, *args)
                torch.cuda.synchronize()
                same = all(bit_equal(a, b) for a, b in zip(got, want))
                ok &= same
                print(json.dumps({"check": name, "design": tag,
                                  "frame0": frame0 is f0c,
                                  "bit_equal": same}), flush=True)
    recs, nv, f0 = _records(czd, dev, 256, 500, 9, whole=True)
    tb, ts = czd.edge_tables(dev), czd.c.terminal_sink
    T, mhz = 500, None
    for tag, entry in designs + designs[::-1]:
        fn = lambda: _call(entry, recs, nv, f0, tb, ts)  # noqa: E731
        ms, held = cuda_ms(fn), held_ms(fn)
        mhz = sm_clock(fn, max(ms, 0.2))
        print(json.dumps({"timing": tag, "B": 256, "T": T, "ms": ms,
                          "held_ms": held, "sm_clock_mhz": mhz,
                          "clocks_a_step": held * 1e-3 * mhz * 1e6 / T}),
              flush=True)
    for B in (1, 132):
        sub = {k: v[:B].contiguous() for k, v in recs.items()}
        for tag, entry in designs:
            held = held_ms(lambda: _call(entry, sub, nv[:B].contiguous(),
                                         f0[:B].contiguous(), tb, ts))
            print(json.dumps({"rows": tag, "B": B, "T": T, "held_ms": held,
                              "clocks_a_step": held * 1e-3 * mhz * 1e6 / T}),
                  flush=True)
    print(json.dumps({"host_us": host_parts(czd, recs, nv, f0, old),
                      "B": 256, "T": T}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
