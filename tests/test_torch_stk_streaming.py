"""Single-stream stkint streaming: the port's StreamingRecognizer on
stkint packages (CPU: the plain versions of kernels A, G and F) against
phnrec_tpu's on the same chunks, and the port's DeviceKWSTracker against
phnrec_tpu's on the same sink records.  Mirrors tests/test_stk_streaming.py
on synthetic packages (``synth.write_stk_decode_package`` and
``write_kws_package`` at the tiny shapes, no sentence norm, which streaming
cannot apply) and 3-6 s of seeded audio.

Decode mode: labels equal phnrec_tpu's streaming labels and the port's
own offline decode in names and boundaries, whole, chunked and with
forced commits (a horizon of 64 frames, blocks of 32: the retained window
stays within 64 + 3 x 32 rows and commits at least once), and with a
delayed global <InputXform>.  Scores are differences of float32 path
likes near -1e3; the two packages' log-posteriors differ by a few 1e-5
(GEMMs and convs sum in another order), which moves a score by at most
~2e-4 here (measured), so TOL_SCORE is 2e-3.

KWS mode: LRTrace's end times follow the posteriors' last bit (ROADMAP
Queue 3), so the live hits are held to the offline KWS mode on the
identical log-posteriors the stream computed, and the device tracker to
phnrec_tpu's on identical sink records (equal in every field, for all four
improveKwdEstim / keyword-0-quirk settings, at K 2 and 129)."""

import numpy as np
import pytest
import torch

from phnrec_tpu.decoder import stknet as jst
from phnrec_tpu.pipeline import SpeechRec as JSpeechRec
from phnrec_tpu.streaming import StreamingRecognizer as JSR

from phnrec_tpu_torch import synth
from phnrec_tpu_torch.decoder import stknet as tst
from phnrec_tpu_torch.devtools.scan_variants import lrtrace_case
from phnrec_tpu_torch.ops import lrtrace
from phnrec_tpu_torch.pipeline import SpeechRec
from phnrec_tpu_torch.streaming import StreamingRecognizer

TOL_SCORE = 2e-3


@pytest.fixture(scope="module")
def pkgs(tmp_path_factory):
    root = tmp_path_factory.mktemp("stks")
    out = {}
    for name, pkg in (
            ("loop", synth.write_stk_decode_package(
                root / "loop", "tiny", seed=0, sent_norm=False)),
            ("xform", synth.write_stk_decode_package(
                root / "xform", "tiny", seed=0, sent_norm=False,
                input_xform=True)),
            ("kws", synth.write_kws_package(root / "kws", "tiny", seed=0,
                                            sent_norm=False))):
        out[name] = (JSpeechRec(pkg), SpeechRec(pkg, device="cpu"))
    return out


@pytest.fixture(scope="module")
def raw():
    rng = np.random.default_rng(5)
    return synth.synth_audio(rng, 8000 * 6).astype("<i2").tobytes()


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


@pytest.mark.parametrize("chunk", [len(b"\0\0") * 48000, 3001, 37])
def test_decode_matches_jax_and_offline(pkgs, raw, chunk):
    """Whole and chunked (odd byte counts included) streams give
    phnrec_tpu's streaming labels and the port's own offline decode."""
    jsr, sr = pkgs["loop"]
    got = _run(StreamingRecognizer(sr, block_frames=32), raw, chunk)
    _assert_same(got, _run(JSR(jsr, block_frames=32), raw, chunk))
    _assert_same(got, sr.process_offline("wf", "str", raw).labels)


def test_settled_results_are_prefix(pkgs, raw):
    """Fixed-lag partials are a prefix of the final labels and equal
    phnrec_tpu's partials."""
    jsr, sr = pkgs["loop"]
    rec, jrec = StreamingRecognizer(sr), JSR(jsr)
    half = len(raw) // 2
    rec.process(raw[:half])
    jrec.process(raw[:half])
    part = rec.results(settled_only=True)
    assert part and _key(part) == _key(jrec.results(settled_only=True))
    rec.process(raw[half:])
    assert _key(part) == _key(rec.finish())[: len(part)]


def test_commit_bounds_memory(pkgs, raw):
    """A horizon of 64 frames and blocks of 32: the recognizer commits
    the settled prefix and drops its record rows again and again, the
    retained window stays within 64 + 3 x 32 rows, and the labels equal
    phnrec_tpu's with the same horizon (the commit is no identity on
    random weights, ROADMAP Queue 3)."""
    jsr, sr = pkgs["loop"]
    rec, jrec = (StreamingRecognizer(sr, block_frames=32),
                 JSR(jsr, block_frames=32))
    rec._stk_horizon = jrec._stk_horizon = 64
    peak = 0
    for i in range(0, len(raw), 4096):
        for r in (rec, jrec):
            r.process(raw[i: i + 4096])
            r.results(settled_only=True)       # live-style polling
        if rec._stk_tail is not None:
            peak = max(peak, rec._stk_tail["in_am"].shape[0])
    assert 0 < peak <= 64 + 3 * 32
    got, want = rec.finish(), jrec.finish()
    assert rec._stk_frame0 > 0 and rec._stk_frame0 == jrec._stk_frame0
    assert rec.committed_count == len(jrec._stk_committed) > 0
    _assert_same(got, want)
    assert not rec._stk_recs


def test_delayed_input_xform(pkgs, raw):
    """A global <InputXform> with a delay line (a stacking node): the
    stream carries the delay across blocks and equals phnrec_tpu's stream
    and the port's offline decode."""
    jsr, sr = pkgs["xform"]
    rec = StreamingRecognizer(sr, block_frames=32)
    assert rec._stk_xform is not None
    got = _run(rec, raw, 3001)
    _assert_same(got, _run(JSR(jsr, block_frames=32), raw, 3001))
    _assert_same(got, sr.process_offline("wf", "str", raw).labels)


def _hits_key(labels):
    return sorted((l.start_frames, l.end_frames, l.name, l.score)
                  for l in labels)


def test_live_kws_matches_offline(pkgs, raw):
    """Live KWS through the device tracker: the hits polled chunk by chunk
    (``kws_hits_so_far``) and the final results equal the offline KWS mode
    on the log-posteriors the stream computed, and phnrec_tpu's offline KWS
    mode on them."""
    jsr, sr = pkgs["kws"]
    rec = StreamingRecognizer(sr, block_frames=32)
    assert rec._kws_tracker is not None
    seen = []
    run_block = rec._run_stk_block
    rec._run_stk_block = lambda lp: (seen.append(lp.clone()),
                                     run_block(lp))
    live = []
    for i in range(0, len(raw), 3001):
        rec.process(raw[i: i + 3001])
        live += rec.kws_hits_so_far()
    got = rec.finish()
    live += rec.kws_hits_so_far()
    assert got and _key(live) == _key(got)
    lp = torch.cat(seen)
    want = sr.stk_decoder.decode(lp)
    assert _hits_key(got) == _hits_key(want)
    jwant = jsr.stk_decoder.decode(lp.numpy())
    assert [k[:3] for k in _hits_key(got)] == \
        [k[:3] for k in _hits_key(jwant)]
    np.testing.assert_allclose([k[3] for k in _hits_key(got)],
                               [k[3] for k in _hits_key(jwant)], rtol=0,
                               atol=1e-4)


def _hits(tr):
    return [(h.word, h.start, h.end, h.score, h.new_estim) for h in tr.hits]


@pytest.mark.parametrize("improve", [False, True])
@pytest.mark.parametrize("quirk", [True, False])
@pytest.mark.parametrize("K", [2, 129])
def test_device_tracker_matches_jax(improve, quirk, K):
    """Given the same sink records in three blocks, the port's tracker
    (kernel F's plain version at n = 1) flushes the same hits as
    phnrec_tpu's DeviceKWSTracker, in the same order, for each setting;
    ``feed_device`` on the gathered columns gives them too, and a second
    finish() adds nothing."""
    _, sv, sw, ws, fs, _, _ = lrtrace_case("cpu", 1, 150, K, K + 2,
                                           seed=K + 2)
    sv, sw = sv[:, 0], sw[:, 0]
    kws = [f"k{j}" for j in range(K)]
    kw = dict(improve_kwd_estim=improve, keyword0_time_quirk=quirk)
    jtr = jst.DeviceKWSTracker(kws, 40, -1e30, word_sinks=ws.numpy(),
                               filler_sink=fs, **kw)
    tr = tst.DeviceKWSTracker(kws, 40, -1e30, word_sinks=ws.numpy(),
                              filler_sink=fs, device="cpu", **kw)
    dtr = tst.DeviceKWSTracker(kws, 40, -1e30, device="cpu", **kw)
    before = lrtrace.LAUNCHES
    for a, b in ((0, 50), (50, 51), (51, 150)):
        jtr.feed_sinks(sv[a:b].numpy(), sw[a:b].numpy())
        tr.feed_sinks(sv[a:b], sw[a:b])
        dtr.feed_device(sv[a:b][:, ws.long()], sv[a:b, fs],
                        sw[a:b][:, ws.long()])
        if b == 51:
            key = lambda hs: [(h.word, h.start, h.end) for h in hs]  # noqa
            assert key(tr.collect()) == key(jtr.collect())
    for t in (jtr, tr, dtr):
        t.finish()
    assert tr.t == dtr.t == jtr.t == 150
    assert _hits(tr) == _hits(jtr) == _hits(dtr)
    assert len(tr.hits) > 10
    n = len(tr.hits)
    assert tr.finish() == [] and len(tr.hits) == n
    assert lrtrace.LAUNCHES == before       # CPU tensors: plain, uncounted
