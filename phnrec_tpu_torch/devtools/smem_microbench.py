"""What feeds an FP32 kernel on one SM of the card: warp instructions a
clock for shared-memory loads of 16 and 4 bytes a lane under several address
patterns, and for a pure FMA stream, at 8 and 16 warps a block, one block an
SM; then the SM clock and power while the FMA stream runs.

    python3 -m phnrec_tpu_torch.devtools.smem_microbench

Builds smem_microbench.cu beside it with nvcc (a few seconds) and prints one
JSON line per measurement.  The load costs quoted in csrc/mlp_fused.cu and in
PERF.md come from this script.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

from phnrec_tpu_torch.ops import _build

NAMES = ("lds128 one address", "lds128 4 addresses", "lds128 8 addresses",
         "lds128 32 addresses", "lds32 one address", "lds32 32 addresses",
         "fma")
ITERS = 20000


def main() -> int:
    if not torch.cuda.is_available():
        print("ERROR: no CUDA device", file=sys.stderr)
        return 1
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "smem_microbench.so"
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(Path(__file__).with_suffix(".cu"))], check=True,
                   capture_output=True)
    run = ctypes.CDLL(str(so)).phn_smem_microbench
    run.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.ones(2 + sms * 1024, device="cuda")
    cyc = torch.zeros(sms, dtype=torch.int64, device="cuda")

    def launch(which, threads, iters):
        _build.check(run(which, sms, threads, iters, out.data_ptr(),
                         cyc.data_ptr()), NAMES[which])

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for threads in (256, 512):
        for which, name in enumerate(NAMES):
            launch(which, threads, ITERS)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            launch(which, threads, ITERS)
            end.record()
            torch.cuda.synchronize()
            clocks = float(cyc.float().mean())
            per_iter = 32 if name == "fma" else 8
            instr = ITERS * per_iter * threads // 32
            print(json.dumps({
                "bench": name, "threads": threads, "clocks": clocks,
                "sm_ghz": clocks / start.elapsed_time(end) / 1e6,
                "warp_instr_per_clock_per_sm": instr / clocks,
                "clocks_per_warp_instr": clocks / instr}), flush=True)

    samples = []

    def sample():
        for _ in range(6):
            samples.append(subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,"
                 "power.draw", "--format=csv,noheader"], capture_output=True,
                text=True).stdout.strip())
            time.sleep(0.3)

    th = threading.Thread(target=sample)
    th.start()
    for _ in range(40):
        launch(6, 512, 400000)
    torch.cuda.synchronize()
    th.join()
    print(json.dumps({"under_fma_load": samples}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
