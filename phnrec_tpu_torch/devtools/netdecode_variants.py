"""Compare sources of kernel E (the decode-mode dense network block,
csrc/netdecode.cu) on one CUDA card.

    python3 -m phnrec_tpu_torch.devtools.netdecode_variants [--ablate] \\
        [--sass DIR] [SOURCE.cu ...]

Without a source, the package's csrc/netdecode.cu; an earlier one by
``git show REV:phnrec_tpu_torch/csrc/netdecode.cu > build/netdecode_old.cu``.
Every source is built (package nvcc flags, all at once, into
build/phnrec_tpu_torch/variants/, registers and spills printed; with
``--sass DIR`` its SASS is written to DIR/netdecode_sass_<tag>.txt) and
bound as ops/netdecode.py binds ``phn_net_decode``.  Each is held to the
plain version (``netdecode.compare_live``: values bit for bit where live,
ids where their value is live) on the CZ stkint phoneme loop at n 256 x F
512 (int16 ids) and on synth.dense_kws_net(340, 3, 5) at n 6 x F 48
(int32 ids, the tables in device memory), beam off and 6.0, before any is
timed.  Then all sources are timed in turns (first to last, then last to
first) on the CZ loop, F 512 (chip_smoke.py's inputs): at n 256 by both
timers (``ms``: mlp_variants.cuda_ms, chip_smoke.py's; ``held_ms``:
scan_variants.held_ms) with the SM clock under load and clocks a frame,
and held at n 1 (one warp), 132 and 264.  With ``--ablate`` the last
source is built again once for each of the ABLATIONS below (wrong
results: timed, not checked; a pattern that misses is reported) and
timed held at n 256 and n 1.  One JSON line per build, check and timing;
the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from phnrec_tpu_torch import synth
from phnrec_tpu_torch.decoder.stknet import OFF_BEAM, DenseKWSScan
from phnrec_tpu_torch.devtools.mlp_variants import build, cuda_ms
from phnrec_tpu_torch.devtools.netstep_variants import sm_clock
from phnrec_tpu_torch.devtools.scan_variants import held_ms
from phnrec_tpu_torch.ops import _build, netdecode
from phnrec_tpu_torch.pipeline import SpeechRec

F_TIMED = 512
N_TIMED = (256, 1, 132, 264)   # a warp a stream: 64, 1, 33 and 66 blocks

# regex edits that cut one part out of a kernel: (what, ((pattern, new),
# ...)); every pattern must hit.  The no_obs_prefetch and no_closure* ones
# cut the design of commit 4eb19bd (the next frame's observations loaded
# into registers, the closure's uv / uk round trip), the redux_* ones the
# redux instance
ABLATIONS = (
    ("no_records", ((r"put_id<IdT>\([^;]*;", ";"),
                    (r"g\.(entry_val|sink_val)\[[^;]*;", ";"))),
    ("no_in_am", ((r"put_id<IdT>\(g\.in_am[^;]*;", ";"),)),
    ("no_carry_records",
     ((r"g\.entry_val\[row \* M \+ d\] = en_r\[h\];", ";"),
      (r"put_id<IdT>\(g\.(entry_edge|ex_am), row \* M \+ d, "
       r"(eg_r|xid)\[h\]\);", ";"))),
    ("no_obs_prefetch", ((r"o\[j\] = g\.obs\[\(row \+ 1\)[^;]*;", ";"),)),
    ("no_obs_fetch", ((r"fetch_obs<EPL>\([^;]*;", ";"),)),
    ("no_id_lookup", ((r"ids\[(\(size_t\))?d \* P \+ k\]", "k"),)),
    ("no_closure_pass2", ((r"d0 < D; d0 \+= 64", "d0 < 0; d0 += 64"),)),
    ("no_closure", ((r"d0 < D; d0 \+= 64", "d0 < 0; d0 += 64"),
                    (r"best_sources\([^;]*;", ";"))),
    ("redux_no_pass2", ((r"h < 2; \+\+h\) \{\n        const int d = 32 \* h "
                         r"\+ lane, c = cu\[h\];",
                         "h < 0; ++h) {\n        const int d = 32 * h + lane, "
                         "c = cu[h];"),)),
    ("redux_no_redux", ((r"if \(on\) warp_first_max\(lv, lk, v, k\);",
                         "v = lv; k = lk;"),)),
    ("no_syncwarp", ((r"__syncwarp\(\);", ";"),)),
)


def inputs(dense, dev, n, F, seed):
    """chip_smoke.py's kernel-E inputs: normal observations [n, F, E],
    ragged n_valid (every stream live at n 1), the initial decode
    carry."""
    rng = np.random.default_rng(seed)
    obs = rng.normal(-3, 2, (n, F, dense.E)).astype(np.float32)
    nv = rng.integers(1, F + 1, n)
    nv[::7] = 0
    nv[1::5] = F
    if n == 1:
        nv[:] = F
    return (dense.init_carry_decode(n, dev), torch.from_numpy(obs).to(dev),
            torch.from_numpy(nv.astype(np.int32)).to(dev))


def _bind(lib):
    fn = lib.phn_net_decode
    fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p] * 11)
    fn.restype = ctypes.c_int
    return lib


def _sass(tag: str, out: Path) -> None:
    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    so = _build.BUILD_DIR / "variants" / f"{tag}.so"
    out.mkdir(parents=True, exist_ok=True)
    text = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True).stdout
    path = out / f"netdecode_sass_{tag}.txt"
    path.write_text(text)
    print(json.dumps({"sass": tag, "file": str(path),
                      "lines": text.count("\n")}), flush=True)


def _ablated(src: Path) -> dict:
    """{what: path} of the ablated copies of ``src`` whose patterns all
    hit."""
    text = src.read_text()
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    paths = {}
    for what, edits in ABLATIONS:
        cut, hit = text, True
        for old, new in edits:
            cut, k = re.subn(old, new, cut)
            hit &= k > 0
        if not hit:
            print(json.dumps({"ablation_misses": what}), flush=True)
            continue
        paths[what] = out / f"netdecode_{what}.cu"
        paths[what].write_text(cut)
    return paths


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("ERROR: no CUDA device", file=sys.stderr)
        return 1
    ablate = "--ablate" in argv
    argv = [a for a in argv if a != "--ablate"]
    sass = None
    if "--sass" in argv:
        i = argv.index("--sass")
        sass = Path(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    srcs = {f"netdecode_v{i}": Path(s) for i, s in enumerate(argv)} or \
        {"netdecode_v0": _build.CSRC / "netdecode.cu"}
    cuts = _ablated(list(srcs.values())[-1]) if ablate else {}
    todo = {**srcs, **cuts}

    def build_cut(tag, path):   # an ablation that does not build is reported
        try:
            return build(tag, path)
        except _build.KernelBuildError as e:
            if tag in srcs:
                raise
            print(json.dumps({"ablation_fails_to_build": tag,
                              "log": str(e)[-600:]}), flush=True)
            return None

    with ThreadPoolExecutor(len(todo)) as ex:
        built = dict(zip(todo, ex.map(build_cut, todo, todo.values())))
    libs = {t: _bind(built[t]) for t in srcs}
    cut_libs = {t: _bind(built[t]) for t in cuts if built[t] is not None}
    if sass:
        for tag in srcs:
            _sass(tag, sass)
    dev = torch.device("cuda", 0)
    tmp = tempfile.mkdtemp()
    sr = SpeechRec(synth.write_stk_decode_package(tmp + "/cz", "cz", seed=0),
                   device=dev)
    cz = DenseKWSScan(sr.stk_decoder.decoder)
    cases = {"cz": (cz, 256, F_TIMED, torch.int16),
             "wide_global": (synth.dense_kws_net(340, 3, 5, seed=2), 6, 48,
                             torch.int32)}
    ok = True
    prepared = {}
    for name, (dense, n, F, ids) in cases.items():
        blk = netdecode.build_net_decode_fn(dense)
        prepared[name] = (dense, blk, *inputs(dense, dev, n, F, seed=71),
                          ids)
    for tag, lib in libs.items():
        netdecode._lib = lambda lib=lib: lib
        for name, (dense, blk, carry, obs, nv, ids) in prepared.items():
            for bw in (float(OFF_BEAM), 6.0):
                beam = torch.full((obs.shape[0],), bw, device=dev)
                got = blk(carry, obs, nv, beam, ids)
                want = netdecode.net_decode_block_plain(
                    dense, carry, obs, nv, beam, ids, values=True)
                torch.cuda.synchronize()
                checks = netdecode.compare_live(got, want)
                equal = all(checks.values())
                ok &= equal
                print(json.dumps({"check": name, "source": str(srcs[tag]),
                                  "beam": bw, "equal": equal,
                                  "bad": [k for k, v in checks.items()
                                          if not v]}), flush=True)
    blk = prepared["cz"][1]
    timed = {n: (*inputs(cz, dev, n, F_TIMED, seed=71),
                 torch.full((n,), float(OFF_BEAM), device=dev))
             for n in N_TIMED}

    def call(lib, n):
        netdecode._lib = lambda: lib
        return blk(*timed[n], torch.int16)

    order = list(libs) + list(reversed(libs))
    mhz = None
    for tag in order:
        lib = libs[tag]
        fn = lambda: call(lib, 256)  # noqa: E731
        ms, held = cuda_ms(fn), held_ms(fn)
        mhz = sm_clock(fn, max(held, 0.2))
        print(json.dumps({"timing": str(srcs[tag]), "n": 256, "F": F_TIMED,
                          "ms": ms, "held_ms": held, "sm_clock_mhz": mhz,
                          "clocks_a_frame":
                          held * 1e-3 * mhz * 1e6 / F_TIMED}), flush=True)
    for n in N_TIMED[1:]:
        for tag in order:
            held = held_ms(lambda: call(libs[tag], n))
            print(json.dumps({"streams": str(srcs[tag]), "n": n,
                              "F": F_TIMED, "held_ms": held,
                              "clocks_a_frame":
                              held * 1e-3 * mhz * 1e6 / F_TIMED}),
                  flush=True)
    for n in (256, 1):
        for tag in list(cut_libs) + list(reversed(cut_libs)):
            held = held_ms(lambda: call(cut_libs[tag], n))
            print(json.dumps({"ablation": tag, "n": n, "F": F_TIMED,
                              "held_ms": held, "clocks_a_frame":
                              held * 1e-3 * mhz * 1e6 / F_TIMED}),
                  flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
