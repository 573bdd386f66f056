"""Compare sources of kernel G (the edge-list network scan,
csrc/netscan.cu) on one CUDA card, each with its own wrapper.

    python3 -m phnrec_tpu_torch.devtools.netscan_variants [--ablate] \\
        SOURCE.cu[:WRAPPER.py] [SOURCE.cu[:WRAPPER.py] ...]

A source without a wrapper file is launched by the package's
ops/netscan.py; an earlier source comes with the ops/netscan.py of its
commit (whose ``slot_arrays``, where it has one, makes its tables), e.g.
``git show e0c5b1a:phnrec_tpu_torch/csrc/netscan.cu > build/netscan_v1.cu``
and ``git show e0c5b1a:phnrec_tpu_torch/ops/netscan.py >
build/netscan_v1_ops.py``.  Every source is built (package nvcc flags,
into build/phnrec_tpu_torch/variants/, registers and spills printed) and
held bit for bit to the plain version (carry and all nine records) on the
CZ stkint phoneme loop at B 256 x T 500 with ragged rows, the same with
the per-row values in device memory, and the EN KWS net at B 8 x T 1,000
with a tight beam.  Then all are timed in turns (first to last, then last
to first) at B 256 x T 500 on the CZ loop by both timers (``ms``:
mlp_variants.cuda_ms, chip_smoke.py's; ``held_ms``: scan_variants.held_ms,
the card held while the host enqueues), with the SM clock under load and
clocks a frame.  The last source is also timed at B 1, 132 (a block on
each SM) and 264 (two) to show whether a row's chain or the SM's
instruction rate bounds it.  With ``--ablate`` the last source is built
again once for each of the ABLATIONS below (wrong results: timed, not
checked).  One JSON line per build, check and timing.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
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

# regex edits that cut one part out of the kernel: (what, pattern, new)
ABLATIONS = (
    ("no_records", r"\n\s*rec\.\w+\[[^;]*;", ""),
    ("no_in_model", r"e0 < E; e0 \+= groups", "e0 < 0; e0 += groups"),
    ("no_exits", r"m0 < M; m0 \+= groups", "m0 < 0; m0 += groups"),
    ("no_closure_sinks", r"d0 < n_dst; d0 \+= groups",
     "d0 < 0; d0 += groups"),
    ("no_frame_barriers", r"\n    __syncthreads\(\);\n", "\n"),
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


def main(argv) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ERROR: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    ablate = "--ablate" in argv
    argv = [a for a in argv if a != "--ablate"]
    variants = []
    for i, arg in enumerate(argv):
        src, _, wrap = arg.partition(":")
        mod = _wrapper(wrap) if wrap else netscan
        tag = f"v{i}_{Path(src).stem}"
        variants.append((tag, mod, mod.bind(build(tag, Path(src)))))
    ablated = []
    if ablate:
        src, _, wrap = argv[-1].partition(":")
        mod, text = variants[-1][1], Path(src).read_text()
        out = netscan._build.BUILD_DIR / "variants"
        out.mkdir(parents=True, exist_ok=True)
        for what, old, new in ABLATIONS:
            cut = re.sub(old, new, text)
            if cut == text:
                continue
            path = out / f"netscan_{what}.cu"
            path.write_text(cut)
            ablated.append((what, mod, mod.bind(build(what, path))))
    tmp = tempfile.mkdtemp()
    cz = SpeechRec(synth.write_stk_decode_package(
        os.path.join(tmp, "cz"), "cz", seed=0), device=dev)
    en = SpeechRec(synth.write_kws_package(
        os.path.join(tmp, "en"), "en", seed=0), device=dev)
    czd, end = cz.stk_decoder.decoder, en.stk_decoder.decoder
    cases = {"cz_256x500": (czd, _inputs(czd, dev, 256, 500, 1), {}),
             "cz_global": (czd, _inputs(czd, dev, 64, 200, 2),
                           {"force_global": True}),
             "en_8x1000_beam": (end, _inputs(end, dev, 8, 1000, 3, beam=4.0),
                                {})}
    ok = True
    for name, (dec, args, kw) in cases.items():
        want = netscan.netscan_plain(*args, dec.edge_tables(dev))
        for tag, mod, lib in variants:
            got = mod.launch(lib, *args, _tables(mod, dec, dev), **kw)
            torch.cuda.synchronize()
            same = _equal(got, want)
            ok &= same
            print(json.dumps({"check": name, "variant": tag,
                              "bit_equal": same}), flush=True)
    dec, args, _ = cases["cz_256x500"]
    T = args[1].shape[1]
    for tag, mod, lib in variants + variants[::-1]:
        tb = _tables(mod, dec, dev)
        fn = lambda: mod.launch(lib, *args, tb)  # noqa: E731
        ms, held = cuda_ms(fn), held_ms(fn)
        mhz = sm_clock(fn, max(ms, 0.2))
        print(json.dumps({"timing": tag, "B": 256, "T": T, "ms": ms,
                          "held_ms": held, "sm_clock_mhz": mhz,
                          "clocks_a_frame": held * 1e-3 * mhz * 1e6 / T}),
              flush=True)
    for what, mod, lib in ablated + ablated[::-1]:
        tb = _tables(mod, dec, dev)
        held = held_ms(lambda: mod.launch(lib, *args, tb))
        print(json.dumps({"ablation": what, "B": 256, "T": T,
                          "held_ms": held, "clocks_a_frame":
                          held * 1e-3 * mhz * 1e6 / T}), flush=True)
    tag, mod, lib = variants[-1]
    tb = _tables(mod, dec, dev)
    for B in (1, 132, 264):
        a = _inputs(dec, dev, B, T, 4)
        held = held_ms(lambda: mod.launch(lib, *a, tb))
        print(json.dumps({"rows": tag, "B": B, "T": T, "held_ms": held,
                          "clocks_a_frame": held * 1e-3 * mhz * 1e6 / T}),
              flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
