"""Compare variants of kernels D and D' (the device backtrack,
csrc/backtrack.cu) on one CUDA card.

    python3 -m phnrec_tpu_torch.devtools.backtrack_variants [--ablate] \\
        [--wrapper OLD_BACKTRACK.py] REF.cu [VARIANT.cu ...] [-- VARIANT.cu ...]

Builds every source given (all at once, with the package's nvcc flags, into
build/phnrec_tpu_torch/variants/) and prints each build's registers and
spills; a source that does not build is reported and left out.  With
``--ablate`` each source before a ``--`` is also built once for each of the
ABLATIONS below whose text it holds, with that part cut out; those copies
compute wrong results: they are timed, not checked.  The parent's source is
extracted by the caller, e.g.
``git show HEAD~1:phnrec_tpu_torch/csrc/backtrack.cu > build/backtrack_ref.cu``.

Every build that is not an ablation is held to the plain versions
(ops/backtrack.py::backtrack_plain and backtrack_committed_plain: count,
phn, start and alpha_end bit-equal, the same dtypes) on WALK_CASES, which
chip_smoke.py holds the package's kernels to as well: every template
instance (int16 and int32 starts, D and D'), Histories below one chunk and
over many, the serving shape, B not a multiple of 8, hops of exactly S
frames that land on chunk edges, rows of one segment, Smax below a row's
hop count, pointers off their alignment, and for D' a committed boundary
before, at, inside and past each window and empty windows; and D' with
frame0 = row_offset = 0 is held to D.

Then it times all builds in turns (first to last, then last to first) at
chip_smoke.py's shapes, D at B 256 x T 500 and D' at B 256 x T 512 (the
same inputs: Histories of the plain phoneme-loop scan of Dirichlet
log-posteriors), and D at the serving shape B 256 x T 6,146 (a synthetic
History, hops of 3-9 frames), each by two timers: ``ms`` by
mlp_variants.cuda_ms (chip_smoke.py's) and ``held_ms`` by
scan_variants.held_ms.  It reads the SM clock under load to give clocks a
hop of the longest row, and prints the hops a row (mean, max) of each
shape.  With ``--wrapper`` it also times the host's work in one call of
that file's ``_launch`` (an earlier wrapper's) and of the package's
``launch``, six times each in turns (host_cost), with the medians.  One
JSON line per build, check and timing.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from phnrec_tpu_torch.decoder import phnloop
from phnrec_tpu_torch.devtools.mlp_variants import build, cuda_ms
from phnrec_tpu_torch.devtools.netstep_variants import sm_clock
from phnrec_tpu_torch.devtools.scan_variants import _sync, bit_equal, held_ms
from phnrec_tpu_torch.ops import _build, backtrack, phnloop_viterbi

# text edits that cut one part out of a source: (what, [(old, new), ...]),
# applied to each source that holds every `old`.  The first kernel D (a
# thread per utterance, 128 threads a block):
_ZERO_LOOP = ("  for (; k < smax; ++k) {\n    phn[base + k] = 0;",
              "  for (; k < 0; ++k) {\n    phn[base + k] = 0;")
ABLATIONS = (
    # (a) no zero-fill past the count
    ("no_zero_fill", [_ZERO_LOOP]),
    # (b) no output stores at all; count is still written
    ("no_stores", [_ZERO_LOOP,
                   ("    phn[base + k] = max_phn[h];\n"
                    "    start[base + k] = (StartT)st;\n"
                    "    alpha_end[base + k] = alpha[h];\n", "")]),
    # (c) 32 threads a block
    ("threads32", [("const int threads = 128;", "const int threads = 32;")]),
    # (d) every hop's loads from row 0, hops of 12 frames
    ("loads_row0", [("const size_t h = (size_t)t * B + b;\n"
                     "    const int st = max(ent[h] - ro, f0);",
                     "const size_t h = (size_t)b;\n"
                     "    const int st = max(end - 12 + min(ent[h], 0), f0);")]),
    # the staged kernel D: no walk (every chunk streamed, then the
    # zero-fill of every slot)
    ("no_walk", [("    while (active) {", "    while (false) {")]),
    # ... no gathers and stores of full buffers in the walk
    ("no_flush", [("      if (k == k_flushed + 32) flush();",
                   "      if (k == k_flushed + 32) k_flushed += 32;")]),
    # ... no segment kept by its lane
    ("no_record", [("    if (lane == k - k_flushed) {\n      my_t = t;\n"
                    "      my_st = st;\n    }\n", "")]),
)

# name -> (B, T, dict(seed, hop, smax, one_segment, offset)): hop lengths
# drawn from [hop[0], hop[1]) frames (default 3-21, ~12 like the CZ loop's
# segments), Smax T // 3 + 1 (the CZ loop's) unless given.  Hops of exactly
# 4, 64, 128 and 256 frames from T land on every chunk edge of chunks of
# 64-256 frames.  T >= 2^15 gives int32 starts.
WALK_CASES = {
    "T37_B13": (13, 37, dict(seed=1)),
    "T1_B13": (13, 1, dict(seed=2)),
    "T500_B256": (256, 500, dict(seed=3)),
    "T1000_B1": (1, 1000, dict(seed=4, hop=(1, 60))),
    "hop1_T300": (8, 300, dict(seed=5, hop=(1, 2), smax=301)),
    "hop3_T384": (16, 384, dict(seed=6, hop=(3, 4))),
    "hop4_T512": (9, 512, dict(seed=7, hop=(4, 5))),
    "hop64_T1024": (8, 1024, dict(seed=8, hop=(64, 65))),
    "hop128_T1024": (13, 1024, dict(seed=9, hop=(128, 129))),
    "hop256_T2048": (8, 2048, dict(seed=10, hop=(256, 257))),
    "one_segment": (13, 300, dict(seed=11, one_segment=True)),
    "truncated": (13, 300, dict(seed=12, smax=5)),
    "offset": (13, 250, dict(seed=13, offset=True)),
    "serving": (256, 6146, dict(seed=14)),
    "i32_T33000_B2": (2, 33000, dict(seed=15)),
    "i32_hop8_T32768_B3": (3, 32768, dict(seed=16, hop=(8, 9))),
}


def _t(a, dev, offset=False):
    """numpy -> a contiguous tensor on ``dev``; with ``offset``, a view one
    element into a larger buffer (off the allocation's alignment)."""
    x = torch.from_numpy(np.ascontiguousarray(a))
    if not offset:
        return x.to(dev)
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
    return buf[1:].view(x.shape).copy_(x)


def walk_case(dev, B, T, seed, hop=(3, 22), smax=None, one_segment=False,
              offset=False):
    """A synthetic History [T, B] and both walks' arguments.  Frame t of a
    column enters at t + 1 - L (clipped at 0), L drawn from ``hop``;
    winners 0-45, scores normal with some -0.0 and +0.0; with
    ``one_segment`` every third column enters at 0.  D: n_frames in
    [1, T] (T and 1 among them).  D': the same History as a window of
    row_offset in [0, 100] (entry frames global), n_rel in [0, T] (0 and T
    among them) and frame0 before, at, inside and past each window.
    -> (D args, D' args), both ending in smax."""
    rng = np.random.default_rng(seed)
    smax = T // 3 + 1 if smax is None else smax
    L = rng.integers(hop[0], hop[1], (T, B))
    local = np.maximum(np.arange(T)[:, None] + 1 - L, 0)
    if one_segment:
        local[:, ::3] = 0
    phn = rng.integers(0, 46, (T, B)).astype(np.int8)
    alpha = rng.normal(-50, 30, (T, B)).astype(np.float32)
    alpha[rng.random((T, B)) < 0.05] = -0.0
    alpha[rng.random((T, B)) < 0.05] = 0.0
    nf = rng.integers(1, T + 1, B)
    nf[::5], nf[1::7] = T, 1
    d = (_t(phn, dev, offset), _t(local.astype(np.int32), dev, offset),
         _t(alpha, dev, offset), _t(nf.astype(np.int32), dev), smax)
    ro = rng.integers(0, 101, B)
    n_rel = rng.integers(0, T + 1, B)
    n_rel[::6], n_rel[1::6] = 0, T
    inside = ro + rng.integers(1, np.maximum(n_rel, 1) + 1)
    f0 = np.choose(np.arange(B) % 5, [ro - 5, ro, inside, ro + n_rel + 3,
                                      ro + rng.integers(0, T + 1, B)])
    ent_g = np.maximum(ro[None, :] + np.arange(T)[:, None] + 1 - L, 0)
    dp = (d[0], _t(ent_g.astype(np.int32), dev, offset), d[2],
          _t(n_rel.astype(np.int32), dev), _t(f0.astype(np.int32), dev),
          _t(ro.astype(np.int32), dev), smax)
    return d, dp


NAMES = ("count", "phn", "start", "alpha_end")
_plain = {}


def _segs_bad(got, want) -> list:
    return [w for a, b, w in zip(got, want, NAMES)
            if a.dtype != b.dtype or not bit_equal(a, b)]


def check_walk_cases(walk, walk_committed, dev) -> list:
    """``walk`` (backtrack's arguments) and ``walk_committed``
    (backtrack_committed's) against the plain versions on every case of
    WALK_CASES, and D' with frame0 = row_offset = 0 against D.  The plain
    results are kept for the next source.  -> one record per case, with
    its bad parts."""
    recs = []
    for case, (B, T, kw) in WALK_CASES.items():
        d, dp = walk_case(dev, B, T, **kw)
        if case not in _plain:
            _plain[case] = (backtrack.backtrack_plain(*d),
                            backtrack.backtrack_committed_plain(*dp))
        want_d, want_dp = _plain[case]
        got_d, got_dp = walk(*d), walk_committed(*dp)
        zero = torch.zeros(B, dtype=torch.int32, device=dev)
        got_0 = walk_committed(*d[:4], zero, zero, d[4])
        _sync(dev)
        bad = [f"D:{w}" for w in _segs_bad(got_d, want_d)]
        bad += [f"D':{w}" for w in _segs_bad(got_dp, want_dp)]
        bad += [f"D'0:{w}" for w in _segs_bad(got_0, got_d)]
        recs.append(dict(case=case, B=B, T=T, smax=d[4],
                         start_dtype=str(want_d[2].dtype),
                         hops_D=hops(want_d[0]), hops_Dp=hops(want_dp[0]),
                         bad=bad))
    return recs


def hops(count: torch.Tensor) -> dict:
    """Hops a row of a walk: mean and max of its counts."""
    c = count.float()
    return dict(mean=float(c.mean()), max=int(count.max()))


def _cz_scan(dev, lp, t0=0):
    spec = phnloop.PhnLoopSpec(n_phonemes=46, n_states=3, w_penalty=-4.6875)
    _, hist = phnloop_viterbi.viterbi_block_plain(
        phnloop.init_carry(spec, lp.shape[0], dev), lp, t0, spec.n_phonemes,
        spec.n_states, spec.w_penalty, spec.log_tr_curr, spec.log_tr_next)
    return hist


def timed_walks(dev) -> dict:
    """The timed shapes -> (kernel, its arguments).  D at B 256 x T 500 and
    D' at B 256 x T 512 on chip_smoke.py's inputs (the same random draws,
    the History from the plain scan, which kernel C equals bit for bit);
    D at the serving shape, B 256 x T 6,146, all rows whole, on a
    synthetic History with hops of 3-9 frames (~1,000 hops a row, as
    chip_smoke.py's serving History has)."""
    B, T, P, S = 256, 500, 46, 3
    rng = np.random.default_rng(4)
    lp = np.log(rng.dirichlet(np.ones(P * S), size=(B, T)))
    hist = _cz_scan(dev, torch.from_numpy(lp.astype(np.float32)).to(dev))
    n_frames = torch.from_numpy(rng.integers(S, T + 1, size=B)
                                .astype(np.int32)).to(dev)
    d500 = (*hist, n_frames, T // S + 1)

    T = 512
    rng = np.random.default_rng(5)

    def lp_of(t):
        return torch.from_numpy(np.log(rng.dirichlet(
            np.ones(P * S), size=(B, t))).astype(np.float32)).to(dev)

    lp_of(T), lp_of(T)                 # the smoke's scan inputs, unused
    rng.integers(0, 5000, B), rng.integers(0, T + 1, B)
    rng.integers(0, T + 1, B)
    hf = _cz_scan(dev, lp_of(T + 160))
    ro = rng.integers(0, 161, B)
    rows = torch.from_numpy(ro).to(dev)[None, :] + \
        torch.arange(T, device=dev)[:, None]
    win = [h.gather(0, rows).contiguous() for h in hf]
    f0 = ro + rng.integers(0, 200, B)
    f0[::11] = ro[::11] - 5
    n_rel = rng.integers(0, T + 1, B)
    n_rel[::7] = T
    i32 = lambda a: torch.from_numpy(  # noqa: E731
        np.asarray(a, np.int32)).to(dev)
    dp512 = (*win, i32(n_rel), i32(f0), i32(ro), T // S + 1)

    d, _ = walk_case(dev, 256, 6146, seed=14, hop=(3, 10))
    serving = (*d[:3], torch.full((256,), 6146, dtype=torch.int32,
                                  device=dev), d[4])
    return {"D B256 x T500": ("D", d500), "D' B256 x T512": ("D'", dp512),
            "D B256 x T6146": ("D", serving)}


def host_cost(fn, n: int = 1000) -> dict:
    """The host's time in one call of ``fn`` (perf_counter around ``n``
    calls, enqueued while a spin kernel holds the card, so the host never
    waits for it), and the card's (CUDA events around the same calls)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(1e9))          # ~0.5 s at the H100's clocks
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    host = time.perf_counter() - t
    end.record()
    torch.cuda.synchronize()
    return dict(host_us=host / n * 1e6, device_ms=start.elapsed_time(end) / n)


def _load_wrapper(path: str):
    spec = importlib.util.spec_from_file_location("backtrack_wrapper", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv) -> int:
    ablate = "--ablate" in argv
    argv = [a for a in argv if a != "--ablate"]
    wrapper = None
    if "--wrapper" in argv:
        i = argv.index("--wrapper")
        wrapper = argv[i + 1]
        del argv[i:i + 2]
    n_ablate = argv.index("--") if "--" in argv else len(argv)
    argv = [a for a in argv if a != "--"]
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
    srcs, checked = {}, []
    for i, a in enumerate(argv):
        tag = f"{i}:{Path(a).stem}"
        srcs[tag] = Path(a)
        checked.append(tag)
        text = Path(a).read_text()
        for what, edits in ABLATIONS if ablate and i < n_ablate else ():
            if not all(old in text for old, _ in edits):
                continue
            cut = text
            for old, new in edits:
                cut = cut.replace(old, new)
            p = out_dir / f"{Path(a).stem}_{i}_{what}.cu"
            p.write_text(cut)
            srcs[f"{tag}:{what}"] = p

    def try_build(tag, src):
        try:
            return backtrack.bind(build(tag, src))
        except _build.KernelBuildError as e:
            print(json.dumps({"build": tag, "failed": str(e)[-2000:]}),
                  flush=True)
            return None

    with ThreadPoolExecutor(len(srcs)) as ex:
        libs = {k: v for k, v in zip(srcs, ex.map(try_build, srcs,
                                                 srcs.values())) if v}
    checked = [c for c in checked if c in libs]

    def calls(lib):
        return dict(
            D=lambda *a: backtrack.launch(lib, *a[:4], None, None, a[4]),
            Dp=lambda *a: backtrack.launch(lib, *a))

    ok = len(checked) == len(argv)
    for name in checked:
        c = calls(libs[name])
        recs = check_walk_cases(c["D"], c["Dp"], dev)
        bad = [r for r in recs if r["bad"]]
        ok = ok and not bad
        print(json.dumps({"check": name, "cases": len(recs),
                          "equal": not bad, "bad": bad,
                          "hops": {r["case"]: r["hops_D"] for r in recs}}),
              flush=True)

    timed = timed_walks(dev)
    max_hops = {}
    for k, (which, args) in timed.items():
        fn = backtrack.backtrack_plain if which == "D" else \
            backtrack.backtrack_committed_plain
        h = hops(fn(*args)[0])
        max_hops[k] = h["max"]
        print(json.dumps({"shape": k, "hops": h}), flush=True)
    timers = {"ms": cuda_ms, "held_ms": held_ms}
    ms = {name: {f"{k} {w}": [] for k in timed for w in timers}
          for name in libs}

    def run(c, k):
        which, args = timed[k]
        return c["D" if which == "D" else "Dp"](*args)

    for name in [*libs, *reversed(libs)]:
        c = calls(libs[name])
        for k in timed:
            for w, timer in timers.items():
                ms[name][f"{k} {w}"].append(
                    timer(lambda: run(c, k), iters=20))
    for name, t in ms.items():
        c = calls(libs[name])
        rec = {"time_ms": name, **t}
        for k in timed:
            mhz = sm_clock(lambda: run(c, k), max(t[f"{k} ms"][0], 0.2))
            rec[f"{k} sm_clock_mhz"] = mhz
            rec[f"{k} held clocks_a_hop"] = [
                v * 1e-3 * mhz * 1e6 / max_hops[k] for v in t[f"{k} held_ms"]]
        print(json.dumps(rec), flush=True)

    if wrapper:
        old = _load_wrapper(wrapper)
        _, args = timed["D B256 x T500"]
        d_args = (*args[:4], None, None, args[4])
        fns = {"old": lambda: old._launch(*d_args),
               "new": lambda: backtrack.launch(None, *d_args)}
        costs = {k: [] for k in fns}
        for _ in range(3):
            for k in [*fns, *reversed(fns)]:
                costs[k].append(host_cost(fns[k]))
        print(json.dumps({"host_cost D B256 x T500": costs, "median_host_us": {
            k: float(np.median([c["host_us"] for c in v]))
            for k, v in costs.items()}, "wrapper": wrapper}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
