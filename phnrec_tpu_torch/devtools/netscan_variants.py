"""Compare sources of kernel G (the edge-list network scan,
csrc/netscan.cu) on one CUDA card, each with its own wrapper.

    python3 -m phnrec_tpu_torch.devtools.netscan_variants [--ablate] \\
        [--sass DIR] [--instance warp|block] \\
        SOURCE.cu[:WRAPPER.py] [SOURCE.cu[:WRAPPER.py] ...]

A source without a wrapper file is launched by the package's
ops/netscan.py; an earlier source comes with the ops/netscan.py of its
commit (whose ``slot_arrays``, where it has one, makes its tables), e.g.
``git show e04e5b5:phnrec_tpu_torch/csrc/netscan.cu > build/netscan_pr10.cu``
and ``git show e04e5b5:phnrec_tpu_torch/ops/netscan.py >
build/netscan_pr10_ops.py``.  A wrapper with ``INSTANCES`` (the warp and
the block instance) is run once for each instance, forced, on every case
the network's sizes let that instance take (``--instance`` keeps one);
an older wrapper runs its one design.

Every source is built (package nvcc flags, into
build/phnrec_tpu_torch/variants/, registers and spills printed; with
``--sass DIR`` its SASS is written to DIR/netscan_sass_<tag>.txt) and
each run is held bit for bit to the plain version (carry and all nine
records) on the CZ stkint phoneme loop at B 256 x T 500 with ragged rows
and at B 1 x T 500, the same with the per-row values in device memory
(the block instance), and the EN KWS net at B 8 x T 1,000 with a tight
beam.  Then all runs are timed in turns (first to last, then last to
first) on the CZ loop at B 256 x T 500 and at B 1 x T 500 by both timers
(``ms``: mlp_variants.cuda_ms, chip_smoke.py's; ``held_ms``:
scan_variants.held_ms, the card held while the host enqueues), with the
SM clock under load and clocks a frame, and at B 132 (a row on each SM)
and 264 (two) held.  With ``--ablate`` the last source is built again
once for each of the ABLATIONS below (wrong results: timed, not checked;
a miss is reported) and timed on the instances the cut belongs to.  One
JSON line per build, check and timing; the card's name and power limit
first.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from phnrec_tpu_torch import synth
from phnrec_tpu_torch.decoder.stknet import OFF_BEAM
from phnrec_tpu_torch.devtools.mlp_variants import build, cuda_ms
from phnrec_tpu_torch.devtools.netstep_variants import sm_clock
from phnrec_tpu_torch.devtools.scan_variants import held_ms
from phnrec_tpu_torch.ops import netscan
from phnrec_tpu_torch.pipeline import SpeechRec

# regex edits that cut one part out of a kernel: (what, the instances it
# is timed on, ((pattern, new), ...)); every pattern must hit
ABLATIONS = (
    ("no_records", ("block", "warp"), ((r"\n\s*rec\.\w+\[[^;]*;", ""),)),
    ("no_in_model", ("block",),
     ((r"e0 < E; e0 \+= groups", "e0 < 0; e0 += groups"),)),
    ("no_exits", ("block",),
     ((r"m0 < M; m0 \+= groups", "m0 < 0; m0 += groups"),)),
    ("no_closure_sinks", ("block",),
     ((r"u0 < U; u0 \+= groups", "u0 < 0; u0 += groups"),
      (r"d = tid; d < D; d \+= THREADS", "d = tid; d < 0; d += THREADS"))),
    ("warp_no_in_model_loads", ("warp",),
     ((r"vin\[isrc\[j\]\[(0|k)\]\] \+ ", ""),)),
    ("warp_no_exit_loads", ("warp",),
     ((r"na\[xsrc\[j\]\[(0|k)\]\] \+ ", ""),)),
    ("warp_no_closure_sinks", ("warp",),
     ((r"if \(s >= SG\) break;", "if (s >= 0) break;"),
      (r"j < W_DPL; \+\+j\) \{\n      const int d = j \* 32 \+ lane;\n"
       r"      const float v", "j < 0; ++j) {\n      const int d = j * 32 + "
       "lane;\n      const float v"))),
    ("warp_no_syncwarp", ("warp",), ((r"\n    __syncwarp\(\);\n", "\n"),)),
)


def _wrapper(path: str):
    spec = importlib.util.spec_from_file_location(
        f"netscan_wrapper_{abs(hash(path))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tables(mod, dec, dev):
    """The edge tables as ``mod``'s launch reads them."""
    tb = dict(dec.edge_tables(dev))
    if hasattr(mod, "slot_arrays"):
        tb.update({k: torch.tensor(v, device=dev)
                   for k, v in mod.slot_arrays(dec.tables).items()})
    return tb


def _inputs(dec, dev, B, T, seed, beam=None):
    rng = np.random.default_rng(seed)
    D = int(dec.c.obs_index.max()) + 1
    lp = np.log(rng.dirichlet(np.ones(D), size=(B, T))).astype(np.float32)
    obs = dec.state_observations(torch.from_numpy(lp).to(dev))
    nv = rng.integers(0, T + 1, B).astype(np.int32)
    nv[::5] = T
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)  # noqa
    return (dec.init_carry(dev, B), obs, i32(np.zeros(B)), i32(nv),
            torch.full((B,), float(OFF_BEAM if beam is None else beam),
                       device=dev))


def _equal(got, want) -> bool:
    def same(a, b):
        if a.dtype == torch.float32:
            return torch.equal(a.view(torch.int32), b.view(torch.int32))
        return torch.equal(a, b)
    return all(same(a, b) for a, b in zip(got[0], want[0])) and all(
        same(got[1][k], want[1][k]) for k in netscan.RECORDS)


def _runs(variants, only):
    """(tag, module, library, instance) for each instance a variant's
    wrapper offers (None: the wrapper has one design)."""
    out = []
    for tag, mod, lib in variants:
        for inst in getattr(mod, "INSTANCES", (None,)):
            if inst is None or only in (None, inst):
                out.append((tag if inst is None else f"{tag}@{inst}", mod,
                            lib, inst))
    return out


def _takes(mod, inst, tb, kw) -> bool:
    """Whether instance ``inst`` of ``mod`` takes the network (and the
    case's options)."""
    if inst is None:
        return True
    if inst == "warp" and kw.get("force_global"):
        return False
    return inst == "block" or mod.plan_instance(tb) == "warp"


def _launch(mod, lib, inst, args, tb, **kw):
    if inst is not None:
        kw["instance"] = inst
    return mod.launch(lib, *args, tb, **kw)


def _sass(tag: str, out: Path) -> None:
    cuobjdump = Path(netscan._build.find_nvcc()).with_name("cuobjdump")
    so = netscan._build.BUILD_DIR / "variants" / f"{tag}.so"
    out.mkdir(parents=True, exist_ok=True)
    text = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True).stdout
    path = out / f"netscan_sass_{tag}.txt"
    path.write_text(text)
    print(json.dumps({"sass": tag, "file": str(path),
                      "lines": text.count("\n")}), flush=True)


def main(argv) -> int:
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
    ablate = "--ablate" in argv
    argv = [a for a in argv if a != "--ablate"]
    opts = {}
    for flag in ("--instance", "--sass"):
        if flag in argv:
            i = argv.index(flag)
            opts[flag] = argv[i + 1]
            argv = argv[:i] + argv[i + 2:]
    only, sass = opts.get("--instance"), opts.get("--sass")
    variants = []
    for i, arg in enumerate(argv):
        src, _, wrap = arg.partition(":")
        mod = _wrapper(wrap) if wrap else netscan
        tag = f"v{i}_{Path(src).stem}"
        variants.append((tag, mod, mod.bind(build(tag, Path(src)))))
        if sass:
            _sass(tag, Path(sass))
    ablated = []
    if ablate:
        src, _, wrap = argv[-1].partition(":")
        mod, text = variants[-1][1], Path(src).read_text()
        out = netscan._build.BUILD_DIR / "variants"
        out.mkdir(parents=True, exist_ok=True)
        for what, insts, edits in ABLATIONS:
            cut, hit = text, True
            for old, new in edits:
                cut, n = re.subn(old, new, cut)
                hit &= n > 0
            if not hit:
                print(json.dumps({"ablation_misses": what}), flush=True)
                continue
            path = out / f"netscan_{what}.cu"
            path.write_text(cut)
            lib = mod.bind(build(what, path))
            for inst in insts:
                if inst in getattr(mod, "INSTANCES", ()):
                    ablated.append((f"{what}@{inst}", mod, lib, inst))
    runs = _runs(variants, only)
    tmp = tempfile.mkdtemp()
    cz = SpeechRec(synth.write_stk_decode_package(
        os.path.join(tmp, "cz"), "cz", seed=0), device=dev)
    en = SpeechRec(synth.write_kws_package(
        os.path.join(tmp, "en"), "en", seed=0), device=dev)
    czd, end = cz.stk_decoder.decoder, en.stk_decoder.decoder
    cases = {"cz_256x500": (czd, _inputs(czd, dev, 256, 500, 1), {}),
             "cz_1x500": (czd, _inputs(czd, dev, 1, 500, 5), {}),
             "cz_global": (czd, _inputs(czd, dev, 64, 200, 2),
                           {"force_global": True}),
             "en_8x1000_beam": (end, _inputs(end, dev, 8, 1000, 3, beam=4.0),
                                {})}
    ok = True
    for name, (dec, args, kw) in cases.items():
        want = netscan.netscan_plain(*args, dec.edge_tables(dev))
        for tag, mod, lib, inst in runs:
            tb = _tables(mod, dec, dev)
            if not _takes(mod, inst, tb, kw):
                continue
            got = _launch(mod, lib, inst, args, tb, **kw)
            torch.cuda.synchronize()
            same = _equal(got, want)
            ok &= same
            print(json.dumps({"check": name, "variant": tag,
                              "bit_equal": same}), flush=True)
    dec = czd
    T = 500
    timed = {256: cases["cz_256x500"][1], 1: cases["cz_1x500"][1]}
    mhz = None
    for B, args in timed.items():
        for tag, mod, lib, inst in runs + runs[::-1]:
            tb = _tables(mod, dec, dev)
            fn = lambda: _launch(mod, lib, inst, args, tb)  # noqa: E731
            ms, held = cuda_ms(fn), held_ms(fn)
            mhz = sm_clock(fn, max(ms, 0.2))
            print(json.dumps({"timing": tag, "B": B, "T": T, "ms": ms,
                              "held_ms": held, "sm_clock_mhz": mhz,
                              "clocks_a_frame": held * 1e-3 * mhz * 1e6 / T}),
                  flush=True)
    args = timed[256]
    for what, mod, lib, inst in ablated + ablated[::-1]:
        tb = _tables(mod, dec, dev)
        held = held_ms(lambda: _launch(mod, lib, inst, args, tb))
        print(json.dumps({"ablation": what, "instance": inst, "B": 256,
                          "T": T, "held_ms": held, "clocks_a_frame":
                          held * 1e-3 * mhz * 1e6 / T}), flush=True)
    for B in (132, 264):
        a = _inputs(dec, dev, B, T, 4)
        for tag, mod, lib, inst in runs:
            tb = _tables(mod, dec, dev)
            held = held_ms(lambda: _launch(mod, lib, inst, a, tb))
            print(json.dumps({"rows": tag, "B": B, "T": T, "held_ms": held,
                              "clocks_a_frame":
                              held * 1e-3 * mhz * 1e6 / T}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
