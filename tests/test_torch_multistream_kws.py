"""Multi-stream KWS serving: the port's MultiStreamKWS (CPU, plain
versions of kernels A, B and F) against phnrec_tpu's (CPU, Pallas in
interpret mode) on the tiny KWS package, 3 streams (full, half and
offset) fed in chunks with block_frames=32.

LRTrace hit end times sit on `lr >= last_lr` comparisons of values that
are often equal in exact arithmetic (the keyword's and the filler's best
paths self-looping in the same phoneme), so they follow the last bit of
the log-posteriors: the two packages' posteriors differ by a few 1e-5
(GEMMs and convs sum in another order), which moves such end times.  So
the serving machinery is held to JAX in two parts: (a) every block's
log-posteriors within TOL_LP of JAX's, with the same per-row frame
offsets and valid counts; (b) fed JAX's log-posteriors, the port's
decoder chain gives JAX's hits exactly (names, times and scores)."""

import jax
import numpy as np
import pytest
import torch

from phnrec_tpu.multistream import MultiStreamKWS as JMS
from phnrec_tpu.pipeline import SpeechRec as JSpeechRec

from phnrec_tpu_torch import synth
from phnrec_tpu_torch.multistream import MultiStreamKWS, MultiStreamRecognizer
from phnrec_tpu_torch.pipeline import SpeechRec

# measured max |port - JAX| over the blocks' valid log-posterior rows:
# 6.0e-5 (gather form), x3 margin
TOL_LP = 2e-4
# with online norm: the estimate is the reference's E[x^2] - mean^2 in
# float32, over mel values near 20 with variances near 1, so the mel's
# ~1e-6 relative differences cancel into inv_std differences of up to
# 1.1e-4 (relative) and log-posterior differences of up to 2.2e-3 (both
# measured), x3 margin
TOL_LP_ONORM = 7e-3
TOL_NORM = 4e-4


@pytest.fixture(scope="module")
def pkgs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mskws")
    kws = synth.write_kws_package(root / "kws", "tiny", seed=0)
    return JSpeechRec(kws), SpeechRec(kws, device="cpu"), \
        SpeechRec(synth.write_lcrc_package(root / "phn", "tiny", seed=0),
                  device="cpu")


@pytest.fixture(scope="module")
def raw():
    rng = np.random.default_rng(5)
    return synth.synth_audio(rng, 8000 * 3).astype("<i2").tobytes()


def _streams(raw):
    return [raw, raw[: len(raw) // 2 // 2 * 2], raw[2 * 1600:]]


def _feed(ms, streams, chunk=3000):
    off = [0] * len(streams)
    while any(o < len(s) for o, s in zip(off, streams)):
        for i, s in enumerate(streams):
            if off[i] < len(s):
                ms.process(i, s[off[i]: off[i] + chunk])
                off[i] += chunk
            elif not ms._ended[i]:
                ms.end_stream(i)
    return ms.finish()


def _key(labels):
    return [(l.start_frames, l.end_frames, l.name, l.score) for l in labels]


class _JCapture(JMS):
    """phnrec_tpu's server, recording each block's decoder input."""

    def __init__(self, *a, **kw):
        self.blocks = []
        super().__init__(*a, **kw)

    def _decode_block(self, carry, lp, n_dec, n_valid):
        jax.debug.callback(
            lambda *x: self.blocks.append(tuple(map(np.asarray, x))),
            lp, n_dec, n_valid, ordered=True)
        return super()._decode_block(carry, lp, n_dec, n_valid)


class _Capture(MultiStreamKWS):
    """The port's server, recording each block's decoder input."""

    def __init__(self, *a, **kw):
        self.blocks = []
        super().__init__(*a, **kw)

    def _decode_block(self, carry, lp, n_dec, n_valid):
        self.blocks.append((lp.clone(), n_valid.clone()))
        return super()._decode_block(carry, lp, n_dec, n_valid)


class _Reslice(MultiStreamKWS):
    """The port's server decoding the frames' log-posteriors recorded by
    another server (each stream's valid rows in frame order), cut into
    its own blocks."""

    def __init__(self, blocks, *a, **kw):
        super().__init__(*a, **kw)
        self.rows = [torch.cat([lp[b, :nv[b]] for lp, nv in blocks])
                     for b in range(self.n)]

    def _decode_block(self, carry, lp, n_dec, n_valid):
        given = torch.zeros_like(lp)
        for b in range(self.n):
            nv = int(n_valid[b])
            given[b, :nv] = self.rows[b][:nv]
            self.rows[b] = self.rows[b][nv:]
        return super()._decode_block(carry, given, n_dec, n_valid)


class _Replay(MultiStreamKWS):
    """The port's server decoding given log-posteriors instead of its own,
    after holding its own to them (TOL_LP) and its bookkeeping to theirs
    (equal)."""

    def __init__(self, blocks, *a, **kw):
        self.blocks, self.err = list(blocks), 0.0
        super().__init__(*a, **kw)

    def _decode_block(self, carry, lp, n_dec, n_valid):
        jlp, jnd, jnv = self.blocks.pop(0)
        np.testing.assert_array_equal(n_dec.numpy(), jnd)
        np.testing.assert_array_equal(n_valid.numpy(), jnv)
        rows = np.arange(lp.shape[1])[None, :] < jnv[:, None]
        if rows.any():
            self.err = max(self.err, float(
                np.abs(lp.numpy() - jlp)[rows].max()))
        return super()._decode_block(carry, torch.tensor(jlp), n_dec,
                                     n_valid)


def test_process_path_matches_jax(pkgs, raw):
    jsr, sr, _ = pkgs
    streams = _streams(raw)
    jms = _JCapture(jsr, n_streams=3, block_frames=32)
    want = _feed(jms, streams)
    ms = _Replay(jms.blocks, sr, n_streams=3, block_frames=32)
    got = _feed(ms, streams)
    assert not ms.blocks and ms.err <= TOL_LP, ms.err
    assert ms.net_path == "kernel_b"
    assert all(want) and [_key(g) for g in got] == [_key(w) for w in want]


def test_device_buffer_matches_jax(pkgs, raw):
    """decode_device_buffer (block loop, bookkeeping on the device, merged
    rings) + finish against phnrec_tpu's scanned dispatch."""
    jsr, sr, _ = pkgs
    x = np.frombuffer(raw, "<i2")
    block, step, vs = 32, 80, 200
    n_blocks = (x.size - (vs - step)) // (block * step)
    audio = np.stack([np.roll(x, -s * 4001) for s in range(3)])
    jms = _JCapture(jsr, n_streams=3, block_frames=block)
    jms.decode_device_buffer(jax.numpy.asarray(audio), n_blocks)
    want = jms.finish()
    ms = _Replay(jms.blocks, sr, n_streams=3, block_frames=block)
    ms.decode_device_buffer(torch.from_numpy(audio), n_blocks)
    got = ms.finish()
    assert not ms.blocks and ms.err <= TOL_LP, ms.err
    assert all(want) and [_key(g) for g in got] == [_key(w) for w in want]


def _onorm_kws_package(root):
    """The tiny KWS package with online norm estimated over each stream's
    first 50 frames and persisted to norms.xml in the package."""
    pkg = synth.write_kws_package(root, "tiny", seed=0)
    with open(f"{pkg}/config", "a") as f:
        f.write(f"[onlinenorm]\nestim_interval=50\nmean_norm=true\n"
                f"var_norm=true\nfile={pkg}/norms.xml\n")
    return pkg


@pytest.mark.parametrize("feed", ["process", "device_buffer"])
def test_online_norm_matches_jax(tmp_path, raw, feed):
    """The device-carried online norm in the fused block (estimation over
    blocks, freeze, apply) gives JAX's log-posteriors within TOL_LP_ONORM
    and, fed JAX's, JAX's hits; finish() persists every stream's estimate
    as JAX does (within TOL_NORM)."""
    from phnrec_tpu_torch.io.normfile import load_norm_file
    jpkg = _onorm_kws_package(tmp_path / "jax")
    tpkg = _onorm_kws_package(tmp_path / "torch")
    jms = _JCapture(JSpeechRec(jpkg), n_streams=3, block_frames=32)
    ms = _Replay([], SpeechRec(tpkg, device="cpu"), n_streams=3,
                 block_frames=32)
    assert ms.online_norm.enabled and ms._onorm_state
    if feed == "process":
        want = _feed(jms, _streams(raw))
        ms.blocks = list(jms.blocks)
        got = _feed(ms, _streams(raw))
    else:
        x = np.frombuffer(raw, "<i2")
        audio = np.stack([np.roll(x, -s * 4001) for s in range(3)])
        n_blocks = (x.size - 120) // (32 * 80)
        jms.decode_device_buffer(jax.numpy.asarray(audio), n_blocks)
        want = jms.finish()
        ms.blocks = list(jms.blocks)
        ms.decode_device_buffer(torch.from_numpy(audio), n_blocks)
        got = ms.finish()
    assert not ms.blocks and ms.err <= TOL_LP_ONORM, ms.err
    assert all(want) and [_key(g) for g in got] == [_key(w) for w in want]
    jn, tn = (load_norm_file(f"{p}/norms.xml") for p in (jpkg, tpkg))
    assert sorted(tn) == sorted(jn) == [0, 1, 2]
    for cid in jn:
        for k in ("mean", "inv_std"):
            np.testing.assert_allclose(tn[cid][k], jn[cid][k],
                                       rtol=TOL_NORM)


def test_device_buffer_in_chunks(pkgs, raw):
    """decode_device_buffer over blocks [0, k) then [k, n) with
    first_block, as a server drains a long buffer, gives the hits of one
    call over [0, n)."""
    _, sr, _ = pkgs
    x = np.frombuffer(raw, "<i2")
    audio = torch.from_numpy(np.stack([np.roll(x, -s * 4001)
                                       for s in range(3)]))
    n_blocks = (x.size - 120) // (32 * 80)
    one = MultiStreamKWS(sr, n_streams=3, block_frames=32)
    one.decode_device_buffer(audio, n_blocks)
    two = MultiStreamKWS(sr, n_streams=3, block_frames=32)
    two.decode_device_buffer(audio, 3)
    two.decode_device_buffer(audio, n_blocks - 3, first_block=3)
    want = one.finish()
    assert all(want) and [_key(g) for g in two.finish()] == \
        [_key(w) for w in want]


def _feed_uneven(ms, raw, chunk=3000):
    """Streams 0 and 1 get ``chunk`` bytes a round, stream 2 a tenth of
    that.  Returns stream 0's decoded frame count once half its audio is
    in (stream 2 then holds less than one block), and finish()."""
    slow = raw[: len(raw) // 10 // 2 * 2]
    half = None
    for off in range(0, len(raw), chunk):
        for i in range(2):
            ms.process(i, raw[off: off + chunk])
        ms.process(2, slow[off // 10 // 2 * 2: (off + chunk) // 10 // 2 * 2])
        if half is None and off + chunk >= len(raw) // 2:
            half = int(ms._n_dec[0])
    for i in range(3):
        ms.end_stream(i)
    return half, ms.finish()


def test_partial_pump_no_head_of_line_blocking(pkgs, raw):
    """partial_pump: a stream fed 10x slower does not stall the others,
    which decode while it trickles; lockstep waits for it.  The policy
    only changes when blocks go, so fed the same log-posteriors, both
    give the same hits."""
    _, sr, _ = pkgs
    lock = _Capture(sr, n_streams=3, block_frames=32)
    half_lock, want = _feed_uneven(lock, raw)
    part = _Capture(sr, n_streams=3, block_frames=32, partial_pump=True)
    half_part, _ = _feed_uneven(part, raw)
    assert half_lock == 0 and half_part >= 3 * 32, (half_lock, half_part)
    assert len(part.blocks) > len(lock.blocks)
    # each frame's log-posteriors, as rows of whichever block carried it
    rows = [torch.cat([lp[b, :nv[b]] for lp, nv in blk.blocks])
            for blk in (lock, part) for b in range(3)]
    for a, b in zip(rows[:3], rows[3:]):
        assert a.shape == b.shape and float((a - b).abs().max()) <= TOL_LP
    # the lockstep server's hits again, its posteriors replayed through
    # the partial policy's blocks
    again = _Reslice(lock.blocks, sr, n_streams=3, block_frames=32,
                     partial_pump=True)
    _, got = _feed_uneven(again, raw)
    assert all(want) and [_key(g) for g in got] == [_key(w) for w in want]


def test_partial_pump_matches_jax(pkgs, raw):
    """The partial policy's blocks (frame offsets, valid counts) and hits
    are phnrec_tpu's under the same uneven feeding."""
    jsr, sr, _ = pkgs
    jms = _JCapture(jsr, n_streams=3, block_frames=32)
    jms.partial_pump = True
    _, want = _feed_uneven(jms, raw)
    ms = _Replay(jms.blocks, sr, n_streams=3, block_frames=32,
                 partial_pump=True)
    _, got = _feed_uneven(ms, raw)
    assert not ms.blocks and ms.err <= TOL_LP, ms.err
    assert all(want) and [_key(g) for g in got] == [_key(w) for w in want]


def test_auto_pump_off_waits_for_pump(pkgs, raw):
    """auto_pump=False: process() only buffers, pump() dispatches; the
    hits are those of the auto-pumped server."""
    _, sr, _ = pkgs
    auto = MultiStreamKWS(sr, n_streams=2, block_frames=32)
    manual = MultiStreamKWS(sr, n_streams=2, block_frames=32,
                            auto_pump=False)
    for ms in (auto, manual):
        for i in range(2):
            ms.process(i, raw)
    assert auto._hist and not manual._hist
    assert manual.pump() == len(auto._hist)
    assert [_key(a) for a in manual.finish()] == \
        [_key(a) for a in auto.finish()]


def test_live_polling_union_is_finish(pkgs, raw):
    """hits_so_far streams new flushes per chunk; union == finish()."""
    _, sr, _ = pkgs
    ms = MultiStreamKWS(sr, n_streams=2, block_frames=32)
    seen = [[], []]
    for off in range(0, len(raw), 8000):
        for i in range(2):
            ms.process(i, raw[off: off + 8000])
        for i in range(2):
            seen[i].extend(ms.hits_so_far(i))
    final = ms.finish()
    for i in range(2):
        seen[i].extend(ms.hits_so_far(i))
        assert final[i] and _key(seen[i]) == _key(final[i])


def test_event_blocks_dropped_after_sync(pkgs, raw):
    _, sr, _ = pkgs
    ms = MultiStreamKWS(sr, n_streams=2, block_frames=32)
    for i in range(2):
        ms.process(i, raw)
    assert ms._hist, "expected pending event blocks"
    first = ms.results()
    assert ms._hist == []
    assert [_key(a) for a in ms.results()] == [_key(a) for a in first]
    final = ms.finish()
    assert ms._hist == []
    for i in range(2):
        assert _key(final[i])[: len(first[i])] == _key(first[i])


def test_set_beam_pruning_is_live(pkgs, raw):
    """The beam rides in the decode carry: changing it after construction
    affects the next blocks (stkinterface.h:108)."""
    _, sr, _ = pkgs
    runs = {}
    for name, beam in (("base", None), ("wide", 1e9), ("narrow", 1.0)):
        ms = MultiStreamKWS(sr, n_streams=1, block_frames=32)
        if beam is not None:
            ms.set_beam_pruning(beam)
        ms.process(0, raw)
        runs[name] = _key(ms.finish()[0])
    assert runs["wide"] == runs["base"], "huge beam must change nothing"
    assert runs["narrow"] != runs["base"], "tight beam must change hits"


def test_ring_overflow_decodes_dense_records(pkgs):
    """A stream whose flush count exceeds the ring's H = max(64, F // 4)
    slots is decoded from the dense records, in emission order, as
    phnrec_tpu does; the other streams from their rings."""
    jsr, sr, _ = pkgs
    N, F, K = 3, 300, 2
    rng = np.random.default_rng(9)
    recs = []
    for r in range(2):
        emit = rng.random((N, F, K)) < (0.4, 0.05)[r]
        emit[0] = False
        recs.append({
            "emit": emit,
            "start": rng.integers(0, 500, (N, F, K)).astype(np.int32),
            "end": rng.integers(0, 500, (N, F, K)).astype(np.int32),
            "score": rng.normal(-30, 5, (N, F, K)).astype(np.float32),
            "new_estim": rng.random((N, F, K)) < 0.3})
    assert recs[0]["emit"][1].sum() > max(64, F // 4)    # overflows
    valid = np.full(N, F, np.int64)
    ms = MultiStreamKWS(sr, n_streams=N, block_frames=F)
    ms._hist = [(ms._compact_events(tuple(
        {k: torch.from_numpy(v) for k, v in rec.items()} for rec in recs)),
        valid)]
    jms = JMS(jsr, n_streams=N, block_frames=F)
    jms._hist = [(jms._compact_events(tuple(
        {k: jax.numpy.asarray(v) for k, v in rec.items()} for rec in recs)),
        valid)]
    got, want = ms.results(), jms.results()
    assert [_key(g) for g in got] == [_key(w) for w in want]
    assert not got[0] and len(got[1]) > 64 and got[2]


def test_rejects(pkgs, tmp_path):
    jsr, sr, phn = pkgs
    with pytest.raises(ValueError, match="MultiStreamKWS"):
        MultiStreamRecognizer(sr, n_streams=2)
    with pytest.raises(ValueError, match="kws"):
        MultiStreamKWS(phn, n_streams=2)
    # the phoneme-loop server takes the phoneme-loop package
    assert MultiStreamRecognizer(phn, n_streams=2).results() == [[], []]
    from tests.test_torch_distributed import one_rank_mesh
    with pytest.raises(TypeError, match="DeviceMesh"):
        MultiStreamKWS(sr, n_streams=2, mesh=object())
    with pytest.raises(ValueError, match="'data'"):
        MultiStreamKWS(sr, n_streams=2, mesh=one_rank_mesh(tmp_path, ("x",)))
    ms = MultiStreamKWS(sr, n_streams=2, mesh=one_rank_mesh(tmp_path))
    assert ms._nl == 2 and ms.finish() == MultiStreamKWS(
        sr, n_streams=2).finish()
    # a global <InputXform> is served now: its delay lines ride in the
    # carry (test_delayed_input_xform_matches_jax)
    xf = synth.write_kws_package(tmp_path / "xf", "tiny", input_xform=True)
    ms = MultiStreamKWS(SpeechRec(xf, device="cpu"), n_streams=2)
    assert ms._xform_inst is not None and ms._carry[3]


def test_irregular_net_runs_kernel_g(pkgs, raw, monkeypatch):
    """When the structure gate rejects the network, the server runs the
    edge-list scan (kernel G, whose sink records feed F) and records it,
    and gives kernel B's hits (the tie-parity invariant)."""
    _, sr, _ = pkgs
    ms = MultiStreamKWS(sr, n_streams=2, block_frames=32)
    from phnrec_tpu_torch.ops import netstep
    monkeypatch.setattr(netstep, "extract_structure", lambda dense: None)
    irr = MultiStreamKWS(sr, n_streams=2, block_frames=32)
    assert (ms.net_path, irr.net_path) == ("kernel_b", "kernel_g")
    for m in (ms, irr):
        for i in range(2):
            m.process(i, raw)
    want = ms.finish()
    assert any(want) and [_key(a) for a in irr.finish()] == \
        [_key(a) for a in want]


def test_delayed_input_xform_matches_jax(tmp_path, raw):
    """A KWS package whose HMM set has a delayed global <InputXform>
    (stacking under linear): each stream's delay lines advance by its valid
    rows only, and fed JAX's log-posteriors the hits are JAX's."""
    pkg = synth.write_kws_package(tmp_path / "xf", "tiny", seed=0,
                                  input_xform=True)
    jsr, sr = JSpeechRec(pkg), SpeechRec(pkg, device="cpu")
    jms = _JCapture(jsr, n_streams=3, block_frames=32)
    assert jms._xform_inst is not None
    want = _feed(jms, _streams(raw))
    ms = _Replay(jms.blocks, sr, n_streams=3, block_frames=32)
    got = _feed(ms, _streams(raw))
    assert ms._xform_inst.total_delay == 1 and ms.net_path == "kernel_b"
    assert not ms.blocks and ms.err <= TOL_LP, ms.err
    assert any(want) and [_key(g) for g in got] == [_key(w) for w in want]


def test_big_network_on_kernel_g_matches_jax(tmp_path, raw):
    """A KWS network past 1,024 models + states (the tiny shape with 60
    generated keywords) runs the edge-list scan (kernel G) and F over its
    sink records; fed JAX's log-posteriors (JAX's edge-list branch), the
    hits are JAX's."""
    pkg = synth.write_kws_package(tmp_path / "big", "tiny", seed=0,
                                  n_keywords=60)
    jsr, sr = JSpeechRec(pkg), SpeechRec(pkg, device="cpu")
    c = sr.stk_decoder.compiled
    assert c.n_models + c.n_states > 1024
    jms = _JCapture(jsr, n_streams=2, block_frames=32)
    assert jms._dense is None
    streams = _streams(raw)[:2]
    want = _feed(jms, streams)
    ms = _Replay(jms.blocks, sr, n_streams=2, block_frames=32)
    got = _feed(ms, streams)
    assert ms.net_path == "kernel_g" and ms._dense is None
    assert not ms.blocks and ms.err <= TOL_LP, ms.err
    assert any(want) and [_key(g) for g in got] == [_key(w) for w in want]
