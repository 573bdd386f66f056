"""The program's own spans and counters in the harness: the tiny cells'
traced dry runs report each metric that reads the program's recorder,
the untraced runs none of them (and leave the recorder off), and the idle
gaps of a traced archive window are named by the program's spans once
``read_profile`` is given their names (the recorder's snapshot holds
them, and ``gap_names`` takes them from it), beside the names of
hooks.json."""

import json
from collections import defaultdict
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tinycells import TINY_MIXES, tiny_root
from portbench import run as R
from phnrec_tpu_torch.utils.profiling import RECORDER

SEED = 2 ** 33 + 11
CPU = torch.device("cpu")
def recorder_metrics(root, cell):
    m = json.loads((root / "BENCHMARK.json").read_text())
    return {x["name"] for x in R.cell_metrics(m, cell, True)
            if x["source"] == "program_span"} - {
        "labels_host_share.archive", "dispatch_host_ms.serve"}


@pytest.fixture
def one_thread():
    """One intra-op thread while the test runs: several test processes
    share the CPU, and a traced live window must hold a few rounds."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("mix", sorted(TINY_MIXES))
def test_traced_runs_report_the_recorders_metrics(tmp_path, one_thread, mix):
    root = tiny_root(tmp_path)
    cell = f"cz_lcrc_n1500.{mix}"
    want = recorder_metrics(root, cell)
    assert len(want) == (3 if mix == "tiny_archive" else 4)
    RECORDER.snapshot()
    last = RECORDER._last
    res = R.run_cell(root, cell, SEED, 0.5, False, CPU)
    assert res["correct"] is True
    assert not want & set(res["metrics"])
    assert RECORDER._cap is None and RECORDER._last is last
    # long enough for the tiny live session's commits, from its third
    # round
    res = R.run_cell(root, cell, SEED + 1, 4.0, True, CPU)
    assert res["correct"] is True
    got = {k: v["value"] for k, v in res["metrics"].items() if k in want}
    assert set(got) == want
    assert all(v >= 0 for v in got.values())
    assert all(got[k] > 0 for k in got
               if k.startswith(("label_build_us", "commit_host_ms")))


class AsDevice:
    """A CPU profile whose matrix products stand in for the card's
    kernels: the rest of the window is the card's idle time."""

    WORK = ("aten::mm", "aten::addmm", "aten::bmm")

    def __init__(self, prof):
        self.prof = prof

    def events(self):
        for e in self.prof.events():
            if e.name in self.WORK:
                yield SimpleNamespace(
                    name=e.name, time_range=e.time_range,
                    device_type=SimpleNamespace(name="CUDA"),
                    is_user_annotation=False)
            else:
                yield e


def test_idle_gaps_are_named_by_the_programs_spans(tmp_path):
    root = tiny_root(tmp_path)
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    hooks = R.load_hooks(root)
    spans = R.Spans(True)
    _, _, _, driver, _ = R.setup_cell(
        root, manifest, "cz_lcrc_n1500.tiny_archive", SEED, CPU,
        str(tmp_path), spans)
    driver.warmup()
    undo = R.install_hooks(hooks, spans, defaultdict(list))
    try:
        # two passes, however slow: the gap between them holds the list
        # path's work outside the batches' products
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            driver.window(0.0)
            driver.window(0.0)
    finally:
        for mod, attr, fn in undo:
            setattr(mod, attr, fn)
    program = set(RECORDER.snapshot().spans)
    assert {"list", "list.loader_wait", "labels.build"} <= program
    assert not program & (set(hooks["spans"]) | set(spans.seconds))
    names = R.gap_names(hooks, spans)
    assert names == set(hooks["spans"]) | set(spans.seconds) | program
    _, _, _, idle = R.read_profile(AsDevice(prof), {}, names)
    by_name = dict(idle)
    named = sum(v for k, v in by_name.items() if k in program)
    assert named > 0
    assert by_name.get("pass", 0.0) < named
