"""Multi-stream stkint decode serving: the port's MultiStreamStkDecode (CPU,
plain versions of kernels A, E, G and H) against phnrec_tpu's (CPU) on a
synthetic stkint decode package (the tiny shape's generated phoneme loop,
word penalty +2 so paths switch phonemes, no sentence norm), block_frames
32.

As tests/test_torch_multistream_kws.py does, the serving machinery is held
to JAX in two parts: every block's log-posteriors within TOL_LP of JAX's,
with the same per-row frame offsets and valid counts; and, fed JAX's
log-posteriors, the port's labels (names, boundaries) and committed
prefixes equal JAX's, scores within TOL_SAME — the records are the same
float32 max-plus sums, the label scores differences of two of them.  The
kernel E route (``net_path`` "kernel_e") is held to JAX's dense step, the
kernel G route to JAX's edge-list scan (PHNREC_TPU_DENSE_STK=0)."""

import os

import jax
import numpy as np
import pytest
import torch

from phnrec_tpu.multistream import MultiStreamStkDecode as JMS
from phnrec_tpu.pipeline import SpeechRec as JSpeechRec

from phnrec_tpu_torch import synth
from phnrec_tpu_torch.multistream import MultiStreamStkDecode
from phnrec_tpu_torch.ops import netdecode
from phnrec_tpu_torch.pipeline import SpeechRec

# measured max |port - JAX| over the blocks' valid log-posterior rows of
# the tiny package: a few 1e-5 (tests/test_torch_multistream_kws.py), x3
TOL_LP = 2e-4
TOL_SAME = 1e-4
# a run with commits against one without: the rebase shifts the retained
# likes by the committed like, so sums round at other magnitudes (float32
# ulp of the ~2,000 cumulative likes of 3 s is 1.2e-4); the JAX package's
# own commit tests allow 5e-3
TOL_REBASE = 5e-3


def _loop_package(root, **kw):
    pkg = synth.write_stk_decode_package(root, "tiny", seed=0,
                                         sent_norm=False, **kw)
    cfg = os.path.join(pkg, "config")
    with open(cfg) as f:
        text = f.read()
    with open(cfg, "w") as f:
        f.write(text.replace("wpenalty=-4.6875", "wpenalty=2.0"))
    return pkg


@pytest.fixture(scope="module")
def pkgs(tmp_path_factory):
    root = tmp_path_factory.mktemp("msstk")
    pkg = _loop_package(root / "loop")
    return JSpeechRec(pkg), SpeechRec(pkg, device="cpu")


@pytest.fixture(scope="module")
def raw():
    rng = np.random.default_rng(5)
    return synth.synth_audio(rng, 8000 * 3).astype("<i2").tobytes()


@pytest.fixture(params=["kernel_e", "kernel_g"])
def route(request, monkeypatch):
    """The network route of both packages' servers."""
    if request.param == "kernel_g":
        monkeypatch.setenv("PHNREC_TPU_DENSE_STK", "0")
        monkeypatch.setattr(netdecode, "build_net_decode_fn",
                            lambda dense: None)
    return request.param


def _streams(raw):
    return [raw, raw[: len(raw) // 2 // 2 * 2], raw[2 * 1600:]]


def _feed(ms, streams, chunk=3000, poll=None):
    off = [0] * len(streams)
    while any(o < len(s) for o, s in zip(off, streams)):
        for i, s in enumerate(streams):
            if off[i] < len(s):
                ms.process(i, s[off[i]: off[i] + chunk])
                off[i] += chunk
            elif not ms._ended[i]:
                ms.end_stream(i)
        if poll:
            poll(ms)
    return ms.finish()


def _key(labels):
    return [(l.start_frames, l.end_frames, l.name) for l in labels]


def _assert_same(got, want, tol=TOL_SAME):
    assert [_key(g) for g in got] == [_key(w) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose([l.score for l in g],
                                   [l.score for l in w], rtol=0, atol=tol)


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


class _Replay(MultiStreamStkDecode):
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


def _pair(pkgs, n=3, **kw):
    jsr, sr = pkgs
    jms = _JCapture(jsr, n_streams=n, block_frames=32, **kw)
    return jms, lambda: _Replay(jms.blocks, sr, n_streams=n,
                                block_frames=32, **kw)


def test_process_path_matches_jax(pkgs, raw, route):
    """Full, half and offset streams fed in chunks: each block's inputs,
    and the labels from JAX's log-posteriors, are JAX's, on either
    route."""
    jms, port = _pair(pkgs)
    want = _feed(jms, _streams(raw))
    ms = port()
    got = _feed(ms, _streams(raw))
    assert ms.net_path == route
    assert not ms.blocks and ms.err <= TOL_LP, ms.err
    assert all(len(w) > 1 for w in want[1:])
    _assert_same(got, want)


def test_device_buffer_matches_jax(pkgs, raw, route):
    """decode_device_buffer over half the blocks (the merged records with
    the delay-gate gap removed), then dispatch_from_device_buffer block by
    block, then the tail through process(): JAX's labels."""
    x = np.frombuffer(raw, "<i2")
    block, step, vs = 32, 80, 200
    spb = block * step
    n_blocks = (x.size - (vs - step)) // spb
    audio = np.stack([np.roll(x, -s * 4001) for s in range(3)])
    tail = [a[n_blocks * spb:].astype("<i2").tobytes() for a in audio]
    half = n_blocks // 2

    def run(ms, buf):
        ms.decode_device_buffer(buf, half)
        for k in range(half, n_blocks):
            ms.dispatch_from_device_buffer(buf, k * spb)
        for i in range(3):
            ms.process(i, tail[i])
        return ms.finish()

    jms, port = _pair(pkgs)
    want = run(jms, jax.numpy.asarray(audio))
    ms = port()
    got = run(ms, torch.from_numpy(audio))
    assert not ms.blocks and ms.err <= TOL_LP, ms.err
    assert all(len(w) > 1 for w in want)
    _assert_same(got, want)


def test_settled_is_prefix(pkgs, raw):
    """results(settled_only=True) mid-stream is a prefix of the final
    labels: a settled word is never rewritten (stkinterface.cpp:222-238)."""
    _, sr = pkgs
    ms = MultiStreamStkDecode(sr, n_streams=2, block_frames=32)
    half = len(raw) // 2 // 2 * 2
    for i in range(2):
        ms.process(i, raw[:half])
    part = ms.results(settled_only=True)
    assert any(part)
    for i in range(2):
        ms.process(i, raw[half:])
        ms.end_stream(i)
    got = ms.finish()
    for i in range(2):
        assert _key(got[i])[: len(part[i])] == _key(part[i])


@pytest.mark.parametrize("walk", ["device", "host"])
def test_commit_bounds_memory_as_jax(pkgs, raw, walk, monkeypatch):
    """record_horizon=64 with live polling: the server commits settled
    labels and drops their record blocks again and again, the retained
    rows stay bounded, and the committed prefixes and final labels are
    JAX's.  ``host``: the walk forced to traceback_host."""
    if walk == "host":
        monkeypatch.setattr(MultiStreamStkDecode, "_device_walk",
                            lambda self: None)
    # streams of one length: JAX's own host walk (ragged blocks) fails on
    # the CPU, where its fetched blocks are read-only
    x = np.frombuffer(raw, "<i2")
    streams = [raw, np.roll(x, -4001).tobytes()]
    jms, port = _pair(pkgs, n=2, record_horizon=64)
    retained = []

    def poll(ms):
        ms.results(settled_only=True)
        retained.append(int((ms._n_dec - ms._row_offset).max()))

    want = _feed(jms, streams, chunk=4096, poll=poll)
    ms = port()
    got = _feed(ms, streams, chunk=4096, poll=poll)
    assert not ms.blocks and ms.err <= TOL_LP, ms.err
    assert max(retained) <= 64 + 3 * 32, retained
    assert all(len(c) > 0 for c in ms._stk_committed), "no commit"
    assert [_key(c) for c in ms._stk_committed] == \
        [_key(c) for c in jms._stk_committed]
    np.testing.assert_array_equal(ms._frame0, jms._frame0)
    _assert_same(got, want)


def test_ragged_commit_takes_host_walk(pkgs, raw):
    """Streams fed at different rates under the partial pump (blocks not
    stream-uniform) with record_horizon=64: the commits walk on the host,
    and the committed prefix plus the window are the labels JAX decodes
    without a commit on the same log-posteriors.  (JAX's own host-walk
    commit cannot run on the CPU: its fetched blocks are read-only there,
    and its rebase writes them in place.)"""
    slow = raw[: len(raw) // 3 // 2 * 2]

    def feed(ms):
        for off in range(0, len(raw), 3000):
            ms.process(0, raw[off: off + 3000])
            ms.process(1, slow[off // 3 // 2 * 2:
                               (off + 3000) // 3 // 2 * 2])
        for i in range(2):
            ms.end_stream(i)
        return ms.finish()

    jsr, sr = pkgs
    jms = _JCapture(jsr, n_streams=2, block_frames=32)
    jms.partial_pump = True
    want = feed(jms)
    ms = _Replay(jms.blocks, sr, n_streams=2, block_frames=32,
                 record_horizon=64, partial_pump=True)
    walks = []
    orig = ms._host_walk
    ms._host_walk = lambda: walks.append(1) or orig()
    got = feed(ms)
    assert not ms.blocks and ms.err <= TOL_LP, ms.err
    assert walks and ms._stk_committed[0], "no host-walk commit"
    _assert_same(got, want, TOL_REBASE)


def test_commit_backoff_when_nothing_settles(pkgs, raw):
    """When no label settles, commit tries back off geometrically instead
    of walking every block; the labels are exact once walks resume."""
    _, sr = pkgs
    ms = MultiStreamStkDecode(sr, n_streams=2, block_frames=32,
                              record_horizon=64)
    calls = [0]
    orig = ms._window_walk

    def stub():
        calls[0] += 1
        return [[] for _ in range(ms.n)]

    ms._window_walk = stub
    for s in range(0, len(raw), 2048):
        for i in range(2):
            ms.process(i, raw[s: s + 2048])
    assert 1 <= calls[0] <= 4, calls[0]
    ms._window_walk = orig
    for i in range(2):
        ms.end_stream(i)
    got = ms.finish()
    ref = MultiStreamStkDecode(sr, n_streams=2, block_frames=32)
    for i in range(2):
        ref.process(i, raw)
        ref.end_stream(i)
    _assert_same(got, ref.finish())


def test_set_beam_pruning_is_live(pkgs, raw, route):
    """The beam rides in the decode carry: a huge beam changes nothing, a
    tight one changes the labels, and either route gives JAX's."""
    jsr, sr = pkgs
    runs = {}
    for name, beam in (("base", None), ("wide", 1e9), ("narrow", 1.5)):
        out = []
        for cls, s in ((JMS, jsr), (MultiStreamStkDecode, sr)):
            ms = cls(s, n_streams=1, block_frames=32)
            if beam is not None:
                ms.set_beam_pruning(beam)
            ms.process(0, raw)
            out.append(_key(ms.finish()[0]))
        assert out[0] == out[1], name
        runs[name] = out[1]
    assert runs["wide"] == runs["base"]
    assert runs["narrow"] != runs["base"]


def test_delayed_input_xform_matches_jax(tmp_path, raw, route):
    """A package whose HMM set has a delayed global <InputXform> (stacking
    under linear): each stream's delay lines advance by its valid rows,
    and the labels are JAX's."""
    pkg = _loop_package(tmp_path / "xf", input_xform=True)
    jsr, sr = JSpeechRec(pkg), SpeechRec(pkg, device="cpu")
    assert sr.stk_decoder.model_set.input_xform.total_delay == 1
    jms = _JCapture(jsr, n_streams=3, block_frames=32)
    want = _feed(jms, _streams(raw))
    ms = _Replay(jms.blocks, sr, n_streams=3, block_frames=32)
    got = _feed(ms, _streams(raw))
    assert ms._xform_inst is not None and ms._carry[2]
    assert not ms.blocks and ms.err <= TOL_LP, ms.err
    _assert_same(got, want)


def test_kernel_e_route_equals_kernel_g_route(pkgs, raw, monkeypatch):
    """The dense route (kernel E) and the edge-list route (kernel G) give
    the same labels: the same records by the tie-parity invariant."""
    _, sr = pkgs
    dense = MultiStreamStkDecode(sr, n_streams=3, block_frames=32)
    monkeypatch.setattr(netdecode, "build_net_decode_fn", lambda dense: None)
    edge = MultiStreamStkDecode(sr, n_streams=3, block_frames=32)
    assert (dense.net_path, edge.net_path) == ("kernel_e", "kernel_g")
    assert dense._rec_i16 and edge._rec_i16
    _assert_same(_feed(dense, _streams(raw)), _feed(edge, _streams(raw)))


def test_host_walk_equals_device_walk(pkgs, raw):
    """The host walk (traceback_host over the fetched blocks) gives the
    device walk's labels on the same retained windows."""
    _, sr = pkgs
    ms = MultiStreamStkDecode(sr, n_streams=3, block_frames=32)
    for i, s in enumerate(_streams(raw)):
        ms.process(i, s[: len(s) // 2 // 2 * 2])
    dev = ms._device_walk()
    assert dev is not None
    host = ms._host_walk()
    assert isinstance(ms._hist[0][0]["in_am"], np.ndarray)
    assert any(dev)
    _assert_same(host, dev)


def test_rejects(pkgs, tmp_path):
    jsr, sr = pkgs
    kws = SpeechRec(synth.write_kws_package(tmp_path / "kws", "tiny"),
                    device="cpu")
    with pytest.raises(ValueError, match="decode"):
        MultiStreamStkDecode(kws, n_streams=2)
    from tests.test_torch_distributed import one_rank_mesh
    with pytest.raises(TypeError, match="DeviceMesh"):
        MultiStreamStkDecode(sr, n_streams=2, mesh=object())
    with pytest.raises(ValueError, match="'data'"):
        MultiStreamStkDecode(sr, n_streams=2,
                             mesh=one_rank_mesh(tmp_path, ("x",)))
    ms = MultiStreamStkDecode(sr, n_streams=2, mesh=one_rank_mesh(tmp_path))
    assert ms._nl == 2 and ms.shard_audio(np.zeros((2, 5), np.int16)).shape \
        == (2, 5)
