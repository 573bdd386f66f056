"""Live recognition (live.py, reference RunLive srec.cpp:1438-1490 and the
live_callback formats phnrec.cpp:71-110) on the port: the five checks of
tests/test_live.py on synthetic packages (no sentence norm, which
streaming cannot apply), plus KWS mode.

File replay: the emitted stream equals the final labels, which equal
phnrec_tpu's run_live on the same bytes (names and boundaries; scores
within TOL_SCORE, as tests/test_torch_streaming.py measures it) and the
port's StreamingRecognizer fed the same 1/8 s chunks (exactly)."""

import io
import os
import sys
import threading
import time

import numpy as np
import pytest

from phnrec_tpu import live as jlive
from phnrec_tpu.pipeline import SpeechRec as JSpeechRec

from phnrec_tpu_torch import cli, synth
from phnrec_tpu_torch.io.labels import Label
from phnrec_tpu_torch.live import ThreadedCapture, format_live, run_live
from phnrec_tpu_torch.pipeline import SpeechRec
from phnrec_tpu_torch.streaming import StreamingRecognizer

TOL_SCORE = 2e-3


@pytest.fixture(scope="module")
def pkgs(tmp_path_factory):
    root = tmp_path_factory.mktemp("live")
    loop = synth.write_lcrc_package(root / "p", "tiny", seed=0,
                                    sent_norm=False)
    kws = synth.write_kws_package(root / "k", "tiny", seed=0,
                                  sent_norm=False)
    return dict(loop=(loop, JSpeechRec(loop), SpeechRec(loop, device="cpu")),
                kws=(kws, None, SpeechRec(kws, device="cpu")))


@pytest.fixture(scope="module")
def raw():
    return synth.synth_audio(np.random.default_rng(5),
                             8000 * 4).astype("<i2").tobytes()


def _key(labels):
    return [(l.start_frames, l.end_frames, l.name) for l in labels]


def test_format_live_variants():
    lab = Label(69, 75, "spk", -71.17)
    for fmt in ("str", "strlen", "lab"):
        assert format_live(lab, fmt) == jlive.format_live(lab, fmt)
    assert format_live(lab, "strlen") == " spk(7)"
    with pytest.raises(ValueError):
        format_live(lab, "bogus")


def _chunked(sr, raw):
    """The port's StreamingRecognizer fed run_live's 1/8 s chunks."""
    tp = sr.cfg.get_int("decoder", "time_pruning")
    rec = StreamingRecognizer(sr, commit_horizon=max(4 * tp, 512))
    chunk = sr.cfg.get_int("source", "sample_freq") // 8 * 2
    for i in range(0, len(raw), chunk):
        rec.process(raw[i: i + chunk])
    return rec.finish()


def test_run_live_file_replay(pkgs, raw, tmp_path):
    _, jsr, sr = pkgs["loop"]
    src = tmp_path / "live.raw"
    src.write_bytes(raw)
    for fmt in ("str", "lab"):
        out = []
        labels = run_live(sr, out_format=fmt, source=str(src),
                          emit=out.append)
        assert labels and out == [format_live(l, fmt) for l in labels]
    assert _key(labels) == _key(_chunked(sr, raw))
    jout = []
    want = jlive.run_live(jsr, out_format="str", source=str(src),
                          emit=jout.append)
    assert _key(labels) == _key(want)
    assert "".join(jout).split() == [l.name for l in labels]
    np.testing.assert_allclose([l.score for l in labels],
                               [l.score for l in want], rtol=0,
                               atol=TOL_SCORE)


def test_run_live_kws_mode(pkgs, raw, tmp_path):
    """KWS mode emits by count, filtered by the per-keyword thresholds;
    the final hits equal the StreamingRecognizer's on the same chunks."""
    _, _, sr = pkgs["kws"]
    src = tmp_path / "kws.raw"
    src.write_bytes(raw)
    out = []
    hits = run_live(sr, out_format="lab", source=str(src), emit=out.append)
    assert _key(hits) == _key(_chunked(sr, raw))
    thr = sr.stk_decoder.keyword_thresholds
    kept = [format_live(h, "lab") for h in hits
            if not h.score < thr.get(h.name)]
    assert hits and sorted(out) == sorted(kept)
    # a threshold above every score filters every emission, not the hits
    orig = sr.stk_decoder.keyword_thresholds

    class High:
        def get(self, name):
            return 1e9
    sr.stk_decoder.keyword_thresholds = High()
    try:
        out2 = []
        again = run_live(sr, source=str(src), emit=out2.append)
    finally:
        sr.stk_decoder.keyword_thresholds = orig
    assert out2 == [] and _key(again) == _key(hits)


def test_threaded_capture_ring():
    """Capture thread + ring (LWFSource semantics): bytes arrive intact and
    in order through the condition-variable handoff."""
    rfd, wfd = os.pipe()
    payload = bytes(range(256)) * 40          # 10240 bytes

    def writer():
        with os.fdopen(wfd, "wb") as w:
            for i in range(0, len(payload), 800):
                w.write(payload[i: i + 800])
                w.flush()
                time.sleep(0.002)

    t = threading.Thread(target=writer)
    t.start()
    cap = ThreadedCapture(os.fdopen(rfd, "rb"), bytes_per_second=16000)
    got = b""
    while True:
        b = cap.read(1000)
        if not b:
            break
        got += b
    t.join()
    assert got == payload


def test_threaded_capture_overflow_stops_recording():
    """When the ring cannot fit another frame the capture thread stops for
    good (lwfsource.cpp:160-176); buffered bytes still drain."""
    class Endless:
        def read(self, n):
            return b"x" * n

    cap = ThreadedCapture(Endless(), bytes_per_second=1000)
    time.sleep(0.2)
    got = b""
    while True:
        b = cap.read(500)
        if not b:
            break
        got += b
    assert cap.capacity - cap.frame_len <= len(got) <= cap.capacity


def test_run_live_pipe_is_lossless(pkgs, raw, monkeypatch, capsys):
    """A pipe is read directly (its backpressure is lossless, no ring): a
    faster-than-real-time pipe through the CLI (-a --device cpu) gives the
    file replay's lines."""
    pkg, _, sr = pkgs["loop"]
    rfd, wfd = os.pipe()

    def writer():
        with os.fdopen(wfd, "wb") as w:
            w.write(raw)          # all at once, far faster than real time

    t = threading.Thread(target=writer)
    t.start()

    class Stdin:
        buffer = os.fdopen(rfd, "rb")
    monkeypatch.setattr(sys, "stdin", Stdin())
    capsys.readouterr()
    try:
        assert cli.main(["-c", pkg, "-a", "-f", "strlen", "--device",
                         "cpu"]) == 0
    finally:
        t.join()
    got = capsys.readouterr().out.splitlines()

    class Buf:
        buffer = io.BytesIO(raw)
    monkeypatch.setattr(sys, "stdin", Buf())
    want = []
    labels = run_live(sr, out_format="strlen", emit=want.append)
    assert got == want == [format_live(l, "strlen") for l in labels]
