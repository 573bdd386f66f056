"""The committed cells on the card: one short run of each through the
command BENCHMARK.json names is correct, and the control on the cell's
own sizes is not.  Skips without a CUDA card."""

import json
import subprocess
import sys

import pytest

from tinycells import ROOT

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(card, cell):
    cmd = json.loads((ROOT / "BENCHMARK.json").read_text())["command"]
    out = subprocess.run(cmd + ["--workload", cell, "--seed", "2147483659",
                                "--seconds", "5", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "-m", "portbench.control",
                          "--workload", cell, "--seeds", "2147483661"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] \
        is False
