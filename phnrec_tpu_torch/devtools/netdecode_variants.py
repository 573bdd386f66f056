"""Compare sources of kernel E (the decode-mode dense network block,
csrc/netdecode.cu) on one CUDA card.

    python3 -m phnrec_tpu_torch.devtools.netdecode_variants \\
        [SOURCE.cu ...]

Without a source, the package's csrc/netdecode.cu; an earlier one by
``git show REV:phnrec_tpu_torch/csrc/netdecode.cu > build/netdecode_old.cu``.
Every source is built (package nvcc flags, into
build/phnrec_tpu_torch/variants/, registers and spills printed) and bound
as ops/netdecode.py binds ``phn_net_decode``.  Each is held to the plain
version (``netdecode.compare_live``: values bit for bit where live, ids
where their value is live) on the CZ stkint phoneme loop at n 256 x F 512
(int16 ids) and on synth.dense_kws_net(340, 3, 5) at n 6 x F 48 (int32
ids, the tables in device memory), beam off and 6.0.  Then all sources are
timed in turns (first to last, then last to first) at the CZ loop n 256 x
F 512 (chip_smoke.py's inputs) by scan_variants.held_ms, with the SM clock
under load and clocks a frame.  One JSON line per build, check and
timing.
"""

from __future__ import annotations

import ctypes
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from phnrec_tpu_torch import synth
from phnrec_tpu_torch.decoder.stknet import OFF_BEAM, DenseKWSScan
from phnrec_tpu_torch.devtools.mlp_variants import build
from phnrec_tpu_torch.devtools.netstep_variants import sm_clock
from phnrec_tpu_torch.devtools.scan_variants import held_ms
from phnrec_tpu_torch.ops import _build, netdecode
from phnrec_tpu_torch.pipeline import SpeechRec


def inputs(dense, dev, n, F, seed):
    """chip_smoke.py's kernel-E inputs: normal observations [n, F, E],
    ragged n_valid, the initial decode carry."""
    rng = np.random.default_rng(seed)
    obs = rng.normal(-3, 2, (n, F, dense.E)).astype(np.float32)
    nv = rng.integers(1, F + 1, n)
    nv[::7] = 0
    nv[1::5] = F
    return (dense.init_carry_decode(n, dev), torch.from_numpy(obs).to(dev),
            torch.from_numpy(nv.astype(np.int32)).to(dev))


def _bind(lib):
    fn = lib.phn_net_decode
    fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p] * 11)
    fn.restype = ctypes.c_int
    return lib


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("ERROR: no CUDA device", file=sys.stderr)
        return 1
    srcs = [Path(a) for a in argv] or [_build.CSRC / "netdecode.cu"]
    libs = [_bind(build(f"netdecode_v{i}", s)) for i, s in enumerate(srcs)]
    dev = torch.device("cuda", 0)
    tmp = tempfile.mkdtemp()
    sr = SpeechRec(synth.write_stk_decode_package(tmp + "/cz", "cz", seed=0),
                   device=dev)
    cases = {"cz": (DenseKWSScan(sr.stk_decoder.decoder), 256, 512,
                    torch.int16),
             "wide_global": (synth.dense_kws_net(340, 3, 5, seed=2), 6, 48,
                             torch.int32)}
    ok = True
    prepared = {}
    for name, (dense, n, F, ids) in cases.items():
        blk = netdecode.build_net_decode_fn(dense)
        prepared[name] = (dense, blk, *inputs(dense, dev, n, F, seed=71),
                          ids)
    for src, lib in zip(srcs, libs):
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
                print(json.dumps({"check": name, "source": str(src),
                                  "beam": bw, "equal": equal,
                                  "bad": [k for k, v in checks.items()
                                          if not v]}), flush=True)
    dense, blk, carry, obs, nv, ids = prepared["cz"]
    beam = torch.full((obs.shape[0],), float(OFF_BEAM), device=dev)
    order = list(range(len(libs))) + list(reversed(range(len(libs))))
    for i in order:
        netdecode._lib = lambda lib=libs[i]: lib
        fn = lambda: blk(carry, obs, nv, beam, ids)  # noqa: E731
        held = held_ms(fn)
        mhz = sm_clock(fn, max(held, 0.2))
        print(json.dumps({"timing": str(srcs[i]), "n": 256, "F": 512,
                          "held_ms": held, "sm_clock_mhz": mhz,
                          "clocks_a_frame": held * 1e-3 * mhz * 1e6 / 512}),
              flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
