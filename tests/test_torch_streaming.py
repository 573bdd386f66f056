"""Single-stream phoneme-loop streaming: the port's StreamingRecognizer
(CPU, plain versions of kernels A and C) against phnrec_tpu's on the same
chunks of the tiny synthetic package (no sentence norm, which streaming
cannot apply), 3 s of synthetic audio, blocks of 32 frames.

Labels are held equal in names and boundaries.  Scores are alpha deltas
of float32 path scores near -1e3: the two packages' log-posteriors differ
by a few 1e-5 (GEMMs and convs sum in another order), which moves a score
by at most 2.4e-4 here (measured), so TOL_SCORE is 2e-3."""

import numpy as np
import pytest

from phnrec_tpu.pipeline import SpeechRec as JSpeechRec
from phnrec_tpu.streaming import StreamingRecognizer as JSR

from phnrec_tpu_torch import synth
from phnrec_tpu_torch.pipeline import SpeechRec
from phnrec_tpu_torch.streaming import StreamingRecognizer

TOL_SCORE = 2e-3


@pytest.fixture(scope="module")
def pkgs(tmp_path_factory):
    pkg = synth.write_lcrc_package(tmp_path_factory.mktemp("st") / "p",
                                   "tiny", seed=0, sent_norm=False)
    return JSpeechRec(pkg), SpeechRec(pkg, device="cpu")


@pytest.fixture(scope="module")
def raw():
    rng = np.random.default_rng(5)
    return synth.synth_audio(rng, 8000 * 3).astype("<i2").tobytes()


def _key(labels):
    return [(l.start_frames, l.end_frames, l.name) for l in labels]


def _assert_same(got, want):
    assert want and _key(got) == _key(want)
    np.testing.assert_allclose([l.score for l in got],
                               [l.score for l in want], rtol=0,
                               atol=TOL_SCORE)


def _run(rec, raw, chunk):
    for i in range(0, len(raw), chunk):
        rec.process(raw[i: i + chunk])
    return rec.finish()


@pytest.mark.parametrize("chunk", [4096, 1000, 37])
def test_chunked_matches_jax_and_offline(pkgs, raw, chunk):
    """Any chunking (odd byte counts included) gives phnrec_tpu's labels
    and the port's own offline decode."""
    jsr, sr = pkgs
    got = _run(StreamingRecognizer(sr, block_frames=32), raw, chunk)
    _assert_same(got, _run(JSR(jsr, block_frames=32), raw, chunk))
    offline = sr.process_offline("wf", "str", raw).labels
    _assert_same(got, offline)


def test_settled_results_are_prefix(pkgs, raw):
    jsr, sr = pkgs
    half = len(raw) // 2
    rec, jrec = StreamingRecognizer(sr, block_frames=32), \
        JSR(jsr, block_frames=32)
    for r in (rec, jrec):
        r.process(raw[:half])
    part, jpart = rec.results(settled_only=True), \
        jrec.results(settled_only=True)
    assert part and _key(part) == _key(jpart)
    # the unsettled tail is longer, and the settled labels end behind the
    # time-pruning horizon
    assert len(rec.results()) >= len(part)
    tp = sr.cfg.get_int("decoder", "time_pruning")
    assert part[-1].end_frames <= rec._n_decoded - tp
    for r in (rec, jrec):
        r.process(raw[half:])
    final = rec.finish()
    assert _key(final)[: len(part)] == _key(part)
    _assert_same(final, jrec.finish())


def test_commit_horizon_matches_jax(pkgs, raw):
    """Fixed-lag commit: the history stays bounded, every commit lands
    where phnrec_tpu's does, and the stitched labels are phnrec_tpu's;
    polling mid-session returns the committed prefix first."""
    jsr, sr = pkgs
    rec = StreamingRecognizer(sr, block_frames=32, commit_horizon=40)
    jrec = JSR(jsr, block_frames=32, commit_horizon=40)
    max_blocks, frames = 0, []
    for i in range(0, len(raw), 2000):
        for r in (rec, jrec):
            r.process(raw[i: i + 2000])
        max_blocks = max(max_blocks, len(rec._hist[0]))
        frames.append((rec._frame0, rec._row_offset, rec.committed_count))
        assert frames[-1] == (jrec._frame0, jrec._row_offset,
                              jrec.committed_count)
        live = rec.results()
        assert _key(live[: rec.committed_count]) == _key(rec._committed)
    got, want = rec.finish(), jrec.finish()
    assert rec._frame0 > 0 and rec.committed_count > 0
    full = StreamingRecognizer(sr, block_frames=32)
    full.process(raw)
    full.finish()
    assert max_blocks < len(full._hist[0])
    _assert_same(got, want)


def _merged(labels):
    out = []
    for l in labels:
        if out and out[-1][2] == l.name and out[-1][1] == l.start_frames:
            out[-1] = (out[-1][0], l.end_frames, l.name)
        else:
            out.append((l.start_frames, l.end_frames, l.name))
    return out


def test_commit_forced_split(pkgs):
    """Quiet noise settles into long segments: a label spanning the whole
    horizon is split there, as phnrec_tpu splits it, and coverage stays
    contiguous.  (phnrec_tpu's own test also finds the full decode once
    the splits are merged; that needs paths that settle within the lag,
    as on speech with trained nets, which the random-weight package does
    not promise: here the forced path ends its first label 15 frames
    away from the full decode's, in phnrec_tpu as in the port.)"""
    jsr, sr = pkgs
    rng = np.random.default_rng(2)
    raw = rng.normal(0, 40, 8000 * 4).astype("<i2").tobytes()
    rec = StreamingRecognizer(sr, block_frames=32, commit_horizon=20)
    jrec = JSR(jsr, block_frames=32, commit_horizon=20)
    got, want = _run(rec, raw, 4096), _run(jrec, raw, 4096)
    _assert_same(got, want)
    full = _run(StreamingRecognizer(sr, block_frames=32), raw, 4096)
    assert rec._frame0 > 0
    for a, b in zip(got, got[1:]):
        assert a.end_frames == b.start_frames
    assert got[0].start_frames == full[0].start_frames
    assert got[-1].end_frames == full[-1].end_frames
    # some commit split a label in two
    assert len(got) > len(_merged(got))


def _onorm_package(root):
    pkg = synth.write_lcrc_package(root, "tiny", seed=0, sent_norm=False)
    with open(f"{pkg}/config", "a") as f:
        f.write("[onlinenorm]\nestim_interval=50\nmean_norm=true\n"
                "var_norm=true\n")
    return pkg


def test_online_norm_matches_jax(tmp_path, raw):
    """Online norm (a host state machine estimating over the first 50
    frames) takes the general block path; labels are phnrec_tpu's."""
    pkg = _onorm_package(tmp_path / "on")
    sr = SpeechRec(pkg, device="cpu")
    rec = StreamingRecognizer(sr, block_frames=32)
    assert rec.online_norm.enabled
    got = _run(rec, raw, 3000)
    want = _run(JSR(JSpeechRec(pkg), block_frames=32), raw, 3000)
    _assert_same(got, want)


def test_set_channel(pkgs):
    _, sr = pkgs
    rec = StreamingRecognizer(sr)
    assert rec.online_norm.cur == sr.cfg.get_int("onlinenorm", "channel")
    rec.set_channel(3)
    assert rec.online_norm.cur == 3 and 3 in rec.online_norm.channels


def test_empty_and_short_streams(pkgs):
    """No audio gives no labels; audio shorter than one frame too; a
    fraction of a block is flushed at finish() as phnrec_tpu flushes it."""
    jsr, sr = pkgs
    assert StreamingRecognizer(sr).finish() == []
    short = StreamingRecognizer(sr)
    short.process(b"\x01\x00" * 50)
    assert short.finish() == []
    rng = np.random.default_rng(8)
    raw = synth.synth_audio(rng, 1600).astype("<i2").tobytes()
    _assert_same(_run(StreamingRecognizer(sr, block_frames=32), raw, 999),
                 _run(JSR(jsr, block_frames=32), raw, 999))


def test_stkint_package_raises(tmp_path):
    """An stkint package streams (tests/test_torch_stk_streaming.py holds
    it to phnrec_tpu): a KWS package gets the device tracker and no
    phoneme-loop state; without an estimator nothing streams."""
    sr = SpeechRec(synth.write_kws_package(tmp_path / "kws", "tiny"),
                   device="cpu")
    rec = StreamingRecognizer(sr, commit_horizon=64)
    assert rec._kws_tracker is not None and rec._stk_horizon == 512
    assert rec.finish() == [] and rec.kws_hits_so_far() == []
    sr.estimator = None
    with pytest.raises(ValueError, match="enabled estimator"):
        StreamingRecognizer(sr)
