"""Compare variants of kernel B's source (the network-Viterbi block) on one
CUDA card.

    python3 -m phnrec_tpu_torch.devtools.netstep_variants [--ablate] \\
        REF.cu [VARIANT.cu ...]

Builds every source given (all at once, with the package's nvcc flags, into
build/phnrec_tpu_torch/variants/) and prints each build's registers and
spills.  Three entry points are known, told apart by the source's text:
``phn_net_block`` with a column map (csrc/netstep.cu: the distinct-column
tables of ops/netstep.py), ``phn_net_block`` without one (an earlier
dense kernel B that read every destination column; its table is rebuilt
here), and ``net_block`` (the first kernel B, which walked
per-destination lists of live edges with one block a stream and one
thread a state; its lists are rebuilt here).  With
``--ablate``, each ``net_block`` source is also built three more times with
a part cut out, to see what its time is made of: the closure walk, the
sink walk, or every block barrier.  Those copies compute wrong records:
they are timed, not checked.

On the EN KWS net of a synthetic package it holds every other build to the
plain version (ops/netstep.py::net_block_plain; the same entries live and
records and carry bit-equal on them) at n 256 x F 512 with normal and
small-integer (tie-heavy) observations, at n 4 and 13, F 1 and with every
stream dead, both beams; then times all builds in turns (first to last,
then last to first) at n 256 x F 512, beam off and 8.0, and reads the SM
clock under load to give clocks a frame.  One JSON line per build, check
and timing.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from phnrec_tpu_torch import synth
from phnrec_tpu_torch.decoder.stknet import NEG, OFF_BEAM, DenseKWSScan
from phnrec_tpu_torch.devtools.mlp_variants import build, cuda_ms
from phnrec_tpu_torch.ops import _build, netstep
from phnrec_tpu_torch.pipeline import SpeechRec

# text edits of the first kernel B's source: (what, [(old, new), ...])
ABLATIONS = (
    ("no_closure", [("cm_hi = cm_ptr[tid + 1];", "cm_hi = cm_lo;")]),
    ("no_sinks", [("cs_hi = cs_ptr[tid + 1];", "cs_hi = cs_lo;")]),
    ("no_barriers", [("__syncthreads();", ";")]),
)


def _lists(A: np.ndarray, extra=None):
    """Per-destination lists of live edges (A[src, dst] > NEG / 2),
    ascending source: ptr [D+1], src, w, extra[src, dst] (the first kernel
    B's tables)."""
    live = A > NEG / 2
    src, w, ex, ptr = [], [], [], [0]
    for d in range(A.shape[1]):
        rows = np.nonzero(live[:, d])[0]
        src.extend(rows.tolist())
        w.extend(A[rows, d].tolist())
        if extra is not None:
            ex.extend(extra[rows, d].astype(np.int32).tolist())
        ptr.append(len(src))
    i32 = lambda v: np.asarray(v if len(v) else [0], np.int32)  # noqa: E731
    return (i32(ptr), i32(src), np.asarray(w if w else [0.0], np.float32),
            i32(ex) if extra is not None else None)


class Dense:
    """Entry point phn_net_block with a column map: NetBlock's tables."""
    keys = ("w_self", "w_adv", "w_entry", "w_exit", "tab", "col_of",
            "reset")

    def __init__(self, blk, dev):
        self.blk, self.t = blk, blk._tables(dev)
        self.ints = (blk.P, blk.U)

    def bind(self, lib):
        fn = lib.phn_net_block
        fn.argtypes = ([ctypes.c_void_p] * (8 + len(self.keys))
                       + [ctypes.c_int] * (6 + len(self.ints))
                       + [ctypes.c_void_p] * 7)
        fn.restype = ctypes.c_int

    def call(self, lib, carry, obs, n_valid, n_dec, beam):
        F, n, E = obs.shape
        b = self.blk
        out = [torch.empty_like(c) for c in carry]
        sv = torch.empty((F, n, b.S), dtype=torch.float32, device=obs.device)
        sw = torch.empty((F, n, b.S), dtype=torch.int32, device=obs.device)
        err = lib.phn_net_block(
            obs.data_ptr(), *(c.data_ptr() for c in carry),
            *(self.t[k].data_ptr() for k in self.keys),
            n_valid.data_ptr(), n_dec.data_ptr(), beam.data_ptr(), F, n, E,
            b.M, b.S, b.S_M, *self.ints, *(o.data_ptr() for o in out),
            sv.data_ptr(), sw.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        _build.check(err, "phn_net_block")
        return tuple(out), (sv, sw)


class AllColumns(Dense):
    """Entry point phn_net_block without a column map: every destination
    column's row in the table, padded to 64 rows."""
    keys = ("w_self", "w_adv", "w_entry", "w_exit", "tab", "reset")

    def __init__(self, blk, dev):
        super().__init__(blk, dev)
        A = np.concatenate([np.asarray(blk.dense.A_cm),
                            np.asarray(blk.dense.A_cs)[:, :blk.S]], 1).T
        tab = np.full((-(-A.shape[0] // 64) * 64, blk.P), -np.inf,
                      np.float32)
        tab[:A.shape[0], :blk.M] = np.where(A > NEG / 2, A, -np.inf)
        self.t = {**self.t, "tab": torch.from_numpy(tab).to(dev)}
        self.ints = (blk.P,)


class Lists(Dense):
    """Entry point net_block: per-destination edge lists, a block a
    stream and a thread a state, model and sink."""

    def __init__(self, blk, dev):
        self.blk = blk
        d = blk.dense
        cm = _lists(np.asarray(d.A_cm), np.asarray(d.R_cm))
        cs = _lists(np.asarray(d.A_cs)[:, :blk.S])
        h = blk._host
        self.host = [h["w_self"], h["w_adv"], h["w_entry"], h["w_exit"],
                     *cm, *cs[:3]]
        self.dev = [torch.from_numpy(a).to(dev) for a in self.host]
        self.threads = -(-max(blk.E, blk.M, blk.S) // 32) * 32

    def bind(self, lib):
        fn = lib.net_block
        fn.argtypes = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p] * 7)
        fn.restype = ctypes.c_int

    def call(self, lib, carry, obs, n_valid, n_dec, beam):
        F, n, E = obs.shape
        b = self.blk
        out = [torch.empty_like(c) for c in carry]
        sv = torch.empty((F, n, b.S), dtype=torch.float32, device=obs.device)
        sw = torch.empty((F, n, b.S), dtype=torch.int32, device=obs.device)
        err = lib.net_block(
            obs.data_ptr(), *(c.data_ptr() for c in carry),
            *(t.data_ptr() for t in self.dev), n_valid.data_ptr(),
            n_dec.data_ptr(), beam.data_ptr(), F, n, E, b.M, b.S, b.S_M,
            self.threads, *(o.data_ptr() for o in out), sv.data_ptr(),
            sw.data_ptr(), torch.cuda.current_stream().cuda_stream)
        _build.check(err, "net_block")
        return tuple(out), (sv, sw)


def inputs(dense, dev, n, F, seed, ties=False, dead=False):
    """chip_smoke.py's inputs: normal or small-integer observations, ragged
    n_valid (all 0 with ``dead``), random n_dec."""
    rng = np.random.default_rng(seed)
    obs = (rng.integers(-3, 1, (F, n, dense.E)) if ties else
           rng.normal(-3, 2, (F, n, dense.E))).astype(np.float32)
    nv = rng.integers(1, F + 1, n)
    nv[::7] = 0
    nv[1::5] = F
    if dead:
        nv[:] = 0
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return (dense.init_carry(n, dev), t(obs), t(nv.astype(np.int32)),
            t(rng.integers(0, 5000, n).astype(np.int32)))


def sm_clock(fn, ms: float) -> int:
    """The SM clock under about a second of launches of ``fn``."""
    for _ in range(max(1, int(1000 / max(ms, 1e-3)))):
        fn()
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    torch.cuda.synchronize()
    return int(out.stdout.split()[0])


def main(argv) -> int:
    ablate = "--ablate" in argv
    argv = [a for a in argv if a != "--ablate"]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ERROR: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    # tagged by position: two sources may share a file name
    srcs, checked = {}, set()
    for i, a in enumerate(argv):
        tag = f"{i}:{Path(a).stem}"
        srcs[tag] = Path(a)
        checked.add(tag)
        text = Path(a).read_text()
        if ablate and "extern \"C\" int net_block(" in text:
            for what, edits in ABLATIONS:
                cut = text
                for old, new in edits:
                    if old not in cut:
                        raise ValueError(f"{a}: no '{old}' to cut")
                    cut = cut.replace(old, new)
                p = out_dir / f"{Path(a).stem}_{what}.cu"
                p.write_text(cut)
                srcs[f"{tag}:{what}"] = p
    with ThreadPoolExecutor(len(srcs)) as ex:
        libs = dict(zip(srcs, ex.map(build, srcs, srcs.values())))

    with tempfile.TemporaryDirectory() as tmp:
        sr = SpeechRec(synth.write_kws_package(tmp + "/en", "en", seed=0),
                       device=dev)
    dense = DenseKWSScan(sr.stk_decoder.decoder)
    blk = netstep.build_net_block_fn(dense)
    kinds = {}
    for name, lib in libs.items():
        text = srcs[name].read_text()
        kind = (Lists if 'extern "C" int net_block(' in text else
                Dense if "const void* col_of" in text else AllColumns)
        kinds[name] = kind(blk, dev)
        kinds[name].bind(lib)

    cases = {"main": (256, 512, dict(seed=21)),
             "ties": (256, 512, dict(seed=23, ties=True)),
             "n4": (4, 512, dict(seed=24)),
             "n13": (13, 512, dict(seed=25)),
             "F1": (256, 1, dict(seed=26)),
             "all_dead": (256, 64, dict(seed=27, dead=True))}
    bad = {name: [] for name in checked}
    for case, (n, F, kw) in cases.items():
        carry, obs, nv, nd = inputs(dense, dev, n, F, **kw)
        for bw in (float(OFF_BEAM), 8.0):
            beam = torch.full((n,), bw, device=dev)
            want = netstep.net_block_plain(dense, carry, obs, nv, nd, beam)
            for name in checked:
                got = kinds[name].call(libs[name], carry, obs, nv, nd, beam)
                torch.cuda.synchronize()
                c = netstep.compare_live(got, want)
                if not all(c.values()):
                    bad[name].append([case, bw, [k for k, v in c.items()
                                                 if not v]])
    for name in checked:
        print(json.dumps({"check": name, "bit_equal_on_live": not bad[name],
                          "bad": bad[name][:10]}), flush=True)

    carry, obs, nv, nd = inputs(dense, dev, 256, 512, seed=21)
    ms = {name: {} for name in libs}
    for name in [*libs, *reversed(libs)]:
        for bw in (float(OFF_BEAM), 8.0):
            beam = torch.full((256,), bw, device=dev)
            ms[name].setdefault(f"beam{bw:g}", []).append(round(cuda_ms(
                lambda: kinds[name].call(libs[name], carry, obs, nv, nd,
                                         beam)), 4))
    beam = torch.full((256,), float(OFF_BEAM), device=dev)
    for name, t in ms.items():
        k = kinds[name]
        mhz = sm_clock(lambda: k.call(libs[name], carry, obs, nv, nd, beam),
                       t[f"beam{float(OFF_BEAM):g}"][0])
        clocks = {b: [round(v * 1e-3 * mhz * 1e6 / 512) for v in vs]
                  for b, vs in t.items()}
        print(json.dumps({"time_ms": name, "n": 256, "F": 512, **t,
                          "sm_clock_mhz": mhz, "clocks_a_frame": clocks}),
              flush=True)
    return 0 if not any(bad.values()) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
