"""The control of a cell's correctness check: the plain reference computed
one precision below the configuration's (TF32 products for float32 with
TF32 off), put in the program's place, and judged as the program is.

    python3 -m portbench.control --workload NAME --seeds N [N ...]

from the root of a checkout, on the cell's own sizes.  For each seed it
makes the cell's inputs as a run does, lets the control answer the
requests the check samples, and prints one JSON line with the numbers
the check compares and whether they pass the cell's limits.  A limit
sits between the largest reading of sound runs and the smallest reading
of the control.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path

import torch

from portbench.run import Spans, reference_module, setup_cell


def control_readings(root: Path, name: str, seed: int, device) -> dict:
    """The checks of one seed with the control in the program's place."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    tmp = tempfile.mkdtemp(prefix="portbench-control-")
    try:
        cfg, limits, pkg, driver, _ = setup_cell(
            root, manifest, name, seed, device, tmp, Spans(False))
        driver.sr = None
        driver.free()
        ref_mod = reference_module(cfg)
        driver.answers_for(ref_mod.Reference(cfg, pkg, device,
                                             control=True))
        verdict = driver.judge(ref_mod.Reference(cfg, pkg, device),
                               ref_mod.judge)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # the control answers only the sampled requests
    checks = {k: [verdict[k], v] for k, v in limits.items()
              if k != "missing_files"}
    readings = {k: v for k, v in verdict.items() if k.endswith("_nats")}
    return dict(workload=name, seed=seed, checks=checks, readings=readings,
                correct=all(v <= lim for v, lim in checks.values()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        print(json.dumps(control_readings(Path.cwd(), args.workload, seed,
                                          device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
