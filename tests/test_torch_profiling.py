"""The port's stage timer and trace capture (utils/profiling.py): the
timer accumulates and summarizes as phnrec_tpu's does, a disabled one
records nothing and syncs nothing, trace() writes a Chrome trace on the
CPU, and the CLI's --profile lists the pipeline's five stages."""

import json
import os

import numpy as np
import pytest
import torch

from phnrec_tpu.utils.profiling import StageTimer as JStageTimer

from phnrec_tpu_torch import cli, synth
from phnrec_tpu_torch.utils import profiling
from phnrec_tpu_torch.utils.profiling import StageTimer, annotate, trace

STAGES = ("wave_convert", "mel_frontend", "posteriors", "viterbi",
          "backtrack")


def test_stage_timer_accumulates_like_jax():
    t, jt = StageTimer(enabled=True), JStageTimer(enabled=True)
    for timer in (t, jt):
        for name in ("mel", "mel", "viterbi"):
            with timer.stage(name, block=torch.zeros(2)):
                pass
    assert {k: v.calls for k, v in t.stats.items()} == \
        {k: v.calls for k, v in jt.stats.items()} == {"mel": 2, "viterbi": 1}
    assert all(v.seconds >= 0.0 for v in t.stats.values())
    assert t.summary().splitlines()[0] == jt.summary().splitlines()[0]
    assert "mel" in t.summary() and "viterbi" in t.summary()
    t.reset()
    assert not t.stats


def test_disabled_timer_is_a_noop(monkeypatch):
    t = StageTimer(enabled=False)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: 1 / 0)
    with t.stage("x", block=torch.device("cuda", 0)):
        pass
    assert not t.stats
    assert not profiling.TIMER.enabled


def test_enabled_timer_syncs_cuda_blocks_and_raises(monkeypatch):
    """An enabled timer syncs each CUDA device of ``block`` once and lets
    an error from the sync propagate (nothing is swallowed)."""
    seen = []
    monkeypatch.setattr(torch.cuda, "synchronize", seen.append)
    t = StageTimer(enabled=True)
    dev = torch.device("cuda", 0)
    with t.stage("x", block={"a": (dev, torch.zeros(1)), "b": [dev]}):
        pass
    assert seen == [dev] and t.stats["x"].calls == 1

    def boom(d):
        raise RuntimeError("sync failed")
    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    with pytest.raises(RuntimeError, match="sync failed"):
        with t.stage("x", block=dev):
            pass


def test_trace_writes_chrome_trace(tmp_path):
    with trace(str(tmp_path / "tr")):
        with annotate("phn_region"):
            torch.ones(8) @ torch.ones(8)
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1 and files[0].endswith(".json")
    ev = json.load(open(tmp_path / "tr" / files[0]))["traceEvents"]
    assert any(e.get("name") == "phn_region" for e in ev)
    with trace(None):                       # no directory: a no-op
        pass


def test_cli_profile_lists_five_stages(tmp_path, capsys):
    pkg = synth.write_lcrc_package(tmp_path / "pkg", "tiny", seed=2)
    f = tmp_path / "a.raw"
    f.write_bytes(synth.synth_audio(np.random.default_rng(0), 12000)
                  .astype("<i2").tobytes())
    profiling.TIMER.reset()
    for argv in (["-i", str(f), "-o", str(tmp_path / "a.rec")],
                 ["-s", "wf", "-t", "par", "-i", str(f), "-o",
                  str(tmp_path / "a.par")],
                 ["-s", "par", "-t", "post", "-i", str(tmp_path / "a.par"),
                  "-o", str(tmp_path / "a.post")]):
        assert cli.main(["--profile", "-c", pkg, "--device", "cpu"]
                        + argv) == 0
    err = capsys.readouterr().err
    rows = {l.split()[0]: int(l.split()[1]) for l in err.splitlines()
            if l.split() and l.split()[0] in STAGES}
    assert set(rows) == set(STAGES) and min(rows.values()) > 0
    assert not profiling.TIMER.enabled
    assert cli.main(["--trace=" + str(tmp_path / "t"), "-c", pkg,
                     "--device", "cpu", "-i", str(f), "-o",
                     str(tmp_path / "b.rec")]) == 0
    assert os.listdir(tmp_path / "t")
    assert (tmp_path / "b.rec").read_text() == \
        (tmp_path / "a.rec").read_text()
