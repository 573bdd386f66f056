"""Multi-stream phoneme-loop serving: the port's MultiStreamRecognizer
(CPU, plain versions of kernels A, C', D and D') against phnrec_tpu's on
the tiny synthetic package (no sentence norm, which streaming cannot
apply): 3 s of synthetic audio per stream, blocks of 32 frames.

Labels are held equal in names and boundaries, scores within TOL_SCORE:
the two packages' log-posteriors differ by a few 1e-5 (GEMMs and convs sum
in another order), which moves a score by at most 2.4e-4 here
(measured)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phnrec_tpu.multistream import MultiStreamRecognizer as JMS
from phnrec_tpu.pipeline import SpeechRec as JSpeechRec

from phnrec_tpu_torch import synth
from phnrec_tpu_torch.decoder import phnloop
from phnrec_tpu_torch.multistream import MultiStreamRecognizer
from phnrec_tpu_torch.pipeline import SpeechRec
from phnrec_tpu_torch.streaming import StreamingRecognizer

TOL_SCORE = 2e-3
BLOCK, STEP, VS = 32, 80, 200


@pytest.fixture(scope="module")
def pkgs(tmp_path_factory):
    pkg = synth.write_lcrc_package(tmp_path_factory.mktemp("ms") / "p",
                                   "tiny", seed=0, sent_norm=False)
    return JSpeechRec(pkg), SpeechRec(pkg, device="cpu")


@pytest.fixture(scope="module")
def raw():
    rng = np.random.default_rng(5)
    return synth.synth_audio(rng, 8000 * 3).astype("<i2").tobytes()


def _streams(raw):
    return [raw, raw[: len(raw) // 2 // 2 * 2], raw[2 * 1600:]]


def _key(labels):
    return [(l.start_frames, l.end_frames, l.name) for l in labels]


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _key(g) == _key(w)
        np.testing.assert_allclose([l.score for l in g],
                                   [l.score for l in w], rtol=0,
                                   atol=TOL_SCORE)


def _feed(ms, streams, chunk=3000, poll=False):
    off = [0] * len(streams)
    while any(o < len(s) for o, s in zip(off, streams)):
        for i, s in enumerate(streams):
            if off[i] < len(s):
                ms.process(i, s[off[i]: off[i] + chunk])
                off[i] += chunk
            elif not ms._ended[i]:
                ms.end_stream(i)
        if poll:
            ms.results()
    return ms.finish()


def _audio(raw, n):
    """[n, L] int16: the stream rolled by 4001 samples per row, cut to
    whole blocks."""
    x = np.frombuffer(raw, "<i2")
    n_blocks = (x.size - (VS - STEP)) // (BLOCK * STEP)
    return np.stack([np.roll(x, -s * 4001) for s in range(n)]), n_blocks


def test_process_path_matches_jax(pkgs, raw):
    jsr, sr = pkgs
    got = _feed(MultiStreamRecognizer(sr, 3, block_frames=BLOCK),
                _streams(raw))
    want = _feed(JMS(jsr, 3, block_frames=BLOCK), _streams(raw))
    assert all(want)
    _assert_same(got, want)


def test_ragged_and_short_streams(pkgs, raw):
    """Streams of very different lengths: one shorter than the LCRC
    latency (10 frames), one of 0.5 s, one empty."""
    jsr, sr = pkgs
    streams = [raw, raw[: 2 * 800], raw[: 2 * 4000], b""]
    out = []
    for ms in (MultiStreamRecognizer(sr, 4, block_frames=BLOCK),
               JMS(jsr, 4, block_frames=BLOCK)):
        for i, s in enumerate(streams):
            if s:
                ms.process(i, s)
            ms.end_stream(i)
        out.append(ms.finish())
    got, want = out
    assert got[3] == [] and want[3] == []
    _assert_same(got, want)


def test_n1_equals_single_stream(pkgs, raw):
    jsr, sr = pkgs
    ms = MultiStreamRecognizer(sr, 1, block_frames=64)
    ms.process(0, raw)
    got = ms.finish()[0]
    rec = StreamingRecognizer(sr, block_frames=64)
    rec.process(raw)
    assert got and _key(got) == _key(rec.finish())
    jms = JMS(jsr, 1, block_frames=64)
    jms.process(0, raw)
    _assert_same([got], jms.finish())


@pytest.mark.parametrize("split", [None, 3])
def test_device_buffer_matches_jax(pkgs, raw, split):
    """decode_device_buffer in one run, and in two runs with first_block
    as a server drains its buffer, then finish(): the lockstep results()
    walk (kernel D) gives phnrec_tpu's labels."""
    jsr, sr = pkgs
    audio, n_blocks = _audio(raw, 3)
    ms = MultiStreamRecognizer(sr, 3, block_frames=BLOCK)
    if split is None:
        ms.decode_device_buffer(torch.from_numpy(audio), n_blocks)
    else:
        ms.decode_device_buffer(torch.from_numpy(audio), split)
        ms.decode_device_buffer(torch.from_numpy(audio), n_blocks - split,
                                first_block=split)
    got = ms.finish()
    jms = JMS(jsr, 3, block_frames=BLOCK)
    jms.decode_device_buffer(jnp.asarray(audio), n_blocks)
    want = jms.finish()
    assert all(want)
    _assert_same(got, want)


def test_dispatch_entry_points_match_jax(pkgs, raw):
    """decode_device_buffer for the first half, dispatch_from_device_buffer
    and dispatch_block_device a block at a time for the rest, then the
    samples left over through process(): phnrec_tpu's labels from the same
    calls, and the single-stream recognizer's on each row."""
    jsr, sr = pkgs
    audio, n_blocks = _audio(raw, 2)
    spb, need = BLOCK * STEP, (BLOCK - 1) * STEP + VS
    half = n_blocks // 2
    tail = [audio[i, n_blocks * spb:].tobytes() for i in range(2)]
    ms = MultiStreamRecognizer(sr, 2, block_frames=BLOCK)
    ta = torch.from_numpy(audio)
    ms.decode_device_buffer(ta, half)
    for k in range(half, n_blocks):
        if k % 2:
            ms.dispatch_from_device_buffer(ta, k * spb)
        else:
            ms.dispatch_block_device(ta[:, k * spb: k * spb + need])
    jms = JMS(jsr, 2, block_frames=BLOCK)
    ja = jnp.asarray(audio)
    jms.decode_device_buffer(ja, half)
    for k in range(half, n_blocks):
        if k % 2:
            jms.dispatch_from_device_buffer(ja, k * spb)
        else:
            jms.dispatch_block_device(ja[:, k * spb: k * spb + need])
    for m in (ms, jms):
        for i in range(2):
            m.process(i, tail[i])
    got = ms.finish()
    _assert_same(got, jms.finish())
    for i in range(2):
        rec = StreamingRecognizer(sr, block_frames=BLOCK)
        rec.process(audio[i].tobytes())
        assert _key(got[i]) == _key(rec.finish())
    with pytest.raises(ValueError, match="does not hold"):
        ms.dispatch_from_device_buffer(ta, ta.shape[1] - need + 1)


def test_commit_device_path_never_fetches_history(pkgs, raw, monkeypatch):
    """Lockstep feeding with commit_horizon: every commit walks the
    retained window with D' (backtrack_device_committed) and rebases in
    place; the History never goes to the host, the retained window stays
    bounded, and labels, commit points and live polls are phnrec_tpu's."""
    jsr, sr = pkgs
    walks, fetches = [], []
    real_walk = phnloop.backtrack_device_committed
    monkeypatch.setattr(phnloop, "backtrack_device_committed",
                        lambda *a, **k: walks.append(1) or real_walk(*a, **k))
    real_fetch = MultiStreamRecognizer._hist_to_host

    def fetch(self):
        # results() before the first block takes the host path on an
        # empty History, as phnrec_tpu's does; a fetch of a block counts
        fetches.extend(1 for h, _ in self._hist
                       if isinstance(h[0], torch.Tensor))
        real_fetch(self)

    monkeypatch.setattr(MultiStreamRecognizer, "_hist_to_host", fetch)
    audio, _ = _audio(raw, 4)
    chunk = BLOCK * STEP * 2                     # one block of samples
    ms = MultiStreamRecognizer(sr, 4, block_frames=BLOCK, commit_horizon=48)
    jms = JMS(jsr, 4, block_frames=BLOCK, commit_horizon=48)
    retained = []
    for c in range(audio.shape[1] * 2 // chunk):
        for i in range(4):
            piece = audio[i].tobytes()[c * chunk: (c + 1) * chunk]
            ms.process(i, piece)
            jms.process(i, piece)
        retained.append(len(ms._hist))
        _assert_same(ms.results(), jms.results())
        np.testing.assert_array_equal(ms._frame0, jms._frame0)
        np.testing.assert_array_equal(ms._row_offset, jms._row_offset)
    assert ms._frame0.min() > 0, "no commit happened"
    assert all(isinstance(h[0], torch.Tensor) for h, _ in ms._hist)
    assert not fetches and len(walks) > len(retained)
    assert max(retained) <= (2 * 48 + BLOCK) // BLOCK + 2
    _assert_same(ms.finish(), jms.finish())


def test_commit_host_fallback_under_ragged_feeding(pkgs, raw):
    """Streams of uneven lengths fed in chunks: per-block validity differs
    between streams, so the commit replays each stream on the host
    (backtrack_committed); commit points and labels are phnrec_tpu's."""
    jsr, sr = pkgs
    ms = MultiStreamRecognizer(sr, 3, block_frames=BLOCK, commit_horizon=40)
    jms = JMS(jsr, 3, block_frames=BLOCK, commit_horizon=40)
    got = _feed(ms, _streams(raw), poll=True)
    want = _feed(jms, _streams(raw), poll=True)
    assert ms._frame0.min() > 0
    assert all(isinstance(h[0], np.ndarray) for h, _ in ms._hist)
    np.testing.assert_array_equal(ms._frame0, jms._frame0)
    assert all(want)
    _assert_same(got, want)


@pytest.mark.parametrize("likes", ["walk", "random"])
@pytest.mark.parametrize("horizon", ["behind_labels", "inside_first",
                                     "at_boundary", "mixed"])
@pytest.mark.parametrize("case", [3, 9])
def test_commit_columns_are_commit_labels_bit_for_bit(case, horizon, likes):
    """columns_from_segments holds labels_from_segments' Labels as arrays,
    and commit_columns over every row at once is commit_labels on each
    row: the same committed labels, boundary frames and boundary likes to
    the bit, forced splits (a horizon inside a row's first label) and rows
    that commit nothing included.  A walk's likes sum exactly in any
    order (differences of float32 scores); random float64 likes in their
    place hold the boundary like to Python's left-to-right sum."""
    from tests.test_torch_phnloop_serving import _window_case
    _, tspec, win, n_rel, f0, ro = _window_case(case, B=4)
    f0 = np.maximum(f0, ro)
    names = [f"p{i}" for i in range(tspec.n_phonemes)]
    segs = phnloop.fetch_segments(phnloop.backtrack_device_committed(
        tspec, phnloop.History(*(torch.from_numpy(a) for a in win)),
        *(torch.from_numpy(a.astype(np.int32)) for a in (n_rel, f0, ro))),
        cap=1000)
    n_glob = (n_rel + ro).astype(np.int64)
    labels = phnloop.labels_from_segments(segs, n_glob, names, row_offset=ro)
    cols = phnloop.columns_from_segments(segs, n_glob, row_offset=ro)
    assert cols.count.tolist() == [len(ls) for ls in labels]
    for b, ls in enumerate(labels):
        k = len(ls)
        assert [phnloop.Label(*x) for x in zip(
            cols.start[b, :k].tolist(), cols.end[b, :k].tolist(),
            [names[i] for i in cols.phn[b, :k]],
            cols.like[b, :k].tolist())] == ls
    rng = np.random.default_rng(case)
    if likes == "random":
        cols = cols._replace(like=rng.normal(-5, 30, cols.like.shape))
        labels = [[phnloop.Label(*x) for x in zip(
            cols.start[b, :k].tolist(), cols.end[b, :k].tolist(),
            [names[i] for i in cols.phn[b, :k]], cols.like[b, :k].tolist())]
            for b, k in enumerate(cols.count.tolist())]
    first = lambda ls: ls[0].start_frames if ls else 0  # noqa: E731
    h = np.array([{"behind_labels": ls[-2].end_frames + 1 if len(ls) > 1
                   else first(ls) + 1,
                   "inside_first": first(ls) + 1,
                   "at_boundary": first(ls),
                   "mixed": [first(ls) + 1, first(ls),
                             ls[len(ls) // 2].end_frames if ls else 0,
                             n_glob[b]][b % 4]}[horizon]
                  for b, ls in enumerate(labels)], np.int64)
    a_h = rng.normal(-40, 20, 4).astype(np.float32)
    (n, start, end, phn, like), frame0, alpha0 = phnloop.commit_columns(
        cols, h, a_h)
    o = 0
    for b, ls in enumerate(labels):
        got = phnloop.commit_labels(ls, int(h[b]), lambda: a_h[b])
        k = int(n[b])
        made = [phnloop.Label(*x) for x in zip(
            start[o: o + k].tolist(), end[o: o + k].tolist(),
            [names[i] for i in phn[o: o + k]], like[o: o + k].tolist())]
        o += k
        if got is None:
            assert k == 0
            continue
        commit, f, a = got
        assert made == commit
        assert frame0[b] == f
        assert np.float64(a).tobytes() == alpha0[b].tobytes()
    assert o == len(start)
    if horizon == "inside_first":
        assert (n[cols.count > 0] == 1).all()


def _silent_streams(raw):
    """[3, L] int16 of whole blocks: speech, speech then silence, and
    silence.  A silent stretch is one long label, which a commit splits
    at its horizon (a forced commit)."""
    x, n_blocks = _audio(raw, 1)
    x = x[0]
    quiet = np.zeros_like(x)
    return np.stack([x, np.where(np.arange(x.size) < x.size // 3, x, 0),
                     quiet]), n_blocks


class _JaxCommit:
    """phnrec_tpu's device commit (its MultiStreamRecognizer.
    _commit_device, run on this object) on the port's walk of a window:
    phnrec_tpu's labels_from_segments of the port's segments, then its
    per-stream policy, boundary frames and likes."""

    def __init__(self, n, horizon, phonemes):
        self.n, self.commit_horizon, self.phonemes = n, horizon, phonemes
        self._committed = [[] for _ in range(n)]
        self._frame0 = np.zeros(n, np.int64)
        self._alpha0 = np.zeros(n, np.float64)
        self.forced = 0

    def commit(self, walk, row_offset):
        from phnrec_tpu.decoder import phnloop as jpl
        segs, n_dec, a_h = walk
        labels = jpl.labels_from_segments(segs, n_dec, self.phonemes,
                                          row_offset=row_offset)
        h = n_dec - self.commit_horizon
        self.forced += sum(
            1 for b, ls in enumerate(labels) if ls and ls[0].start_frames
            < h[b] and not any(l.end_frames <= h[b] for l in ls))
        self._n_dec = n_dec
        self._walk_window_device = lambda key: (labels, a_h)
        JMS._commit_device(self, None)

    def _drop_committed_blocks(self):
        self.alpha0 = self._alpha0.copy()

    def _rebase_device(self, r):
        self._alpha0[:] = 0.0


@pytest.mark.parametrize("poll", [False, True])
def test_lockstep_commits_match_jax(pkgs, raw, monkeypatch, poll):
    """Lockstep feeding with commit_horizon, read only at finish() or
    polled after every block: results() and finish() are phnrec_tpu's and
    the commit points its run's after every block; each commit's boundary
    frames, likes (to the bit) and committed labels are those of
    phnrec_tpu's commit on the same walk, forced splits included (the
    silent streams)."""
    jsr, sr = pkgs
    events = []
    real_walk = MultiStreamRecognizer._walk_window_device
    real_rebase = MultiStreamRecognizer._drop_and_rebase

    def walk(self, key):
        segs, n_dec, a_h = out = real_walk(self, key)
        events.append(("walk", (segs, n_dec.copy(), a_h),
                       self._row_offset.copy()))
        return out

    def rebase(self):
        events.append(("commit", self._frame0.copy(), self._alpha0.copy()))
        real_rebase(self)

    monkeypatch.setattr(MultiStreamRecognizer, "_walk_window_device", walk)
    monkeypatch.setattr(MultiStreamRecognizer, "_drop_and_rebase", rebase)
    audio, _ = _silent_streams(raw)
    chunk = BLOCK * STEP * 2
    ms = MultiStreamRecognizer(sr, 3, block_frames=BLOCK, commit_horizon=40)
    jms = JMS(jsr, 3, block_frames=BLOCK, commit_horizon=40)
    for c in range(audio.shape[1] * 2 // chunk):
        for i in range(3):
            piece = audio[i].tobytes()[c * chunk: (c + 1) * chunk]
            ms.process(i, piece)
            jms.process(i, piece)
        np.testing.assert_array_equal(ms._frame0, jms._frame0)
        if poll:
            _assert_same(ms.results(), jms.results())
    got = ms.finish()
    _assert_same(got, jms.finish())
    policy = _JaxCommit(3, 40, sr.phonemes)
    commits = 0
    for k, ev in enumerate(events):
        if ev[0] != "commit":
            continue
        assert events[k - 1][0] == "walk"
        policy.commit(*events[k - 1][1:])
        np.testing.assert_array_equal(ev[1], policy._frame0)
        assert ev[2].tobytes() == policy.alpha0.tobytes()
        commits += 1
    assert commits >= 3 and policy.forced >= commits
    fields = lambda ls: [(l.start_frames, l.end_frames, l.name,  # noqa
                          l.score) for l in ls]
    want = [fields(c) for c in policy._committed]
    assert [fields(m) for m in ms._made] == want
    assert all(fields(g[: len(c)]) == c for g, c in zip(got, want))


def test_partial_pump_with_one_slow_stream(pkgs, raw):
    """partial_pump: a stream fed 10x slower does not hold the others
    back (they decode past what it has fed), and the labels are
    phnrec_tpu's and the lockstep pump's."""
    jsr, sr = pkgs
    slow = raw[: len(raw) // 10 // 2 * 2]
    out, early = [], []
    for ms in (MultiStreamRecognizer(sr, 3, block_frames=BLOCK,
                                     partial_pump=True),
               JMS(jsr, 3, block_frames=BLOCK, partial_pump=True),
               MultiStreamRecognizer(sr, 3, block_frames=BLOCK)):
        seen = 0
        for off in range(0, len(raw), 3000):
            for i in range(2):
                ms.process(i, raw[off: off + 3000])
            ms.process(2, slow[off // 10 // 2 * 2:
                               (off + 3000) // 10 // 2 * 2])
            seen = max(seen, int(ms._n_dec[0]) - int(ms._n_dec[2]))
        early.append(seen)
        for i in range(3):
            ms.end_stream(i)
        out.append(ms.finish())
    assert early[0] > 2 * BLOCK and early[2] < BLOCK
    _assert_same(out[0], out[1])
    assert [_key(x) for x in out[0]] == [_key(x) for x in out[2]]


def test_rejects(pkgs, tmp_path):
    """A mesh must be a DeviceMesh with a "data" dimension; one at world
    size 1 serves every stream as the unsharded server does (the 2-rank
    run is tests/test_torch_distributed.py's)."""
    from tests.test_torch_distributed import one_rank_mesh
    _, sr = pkgs
    with pytest.raises(TypeError, match="DeviceMesh"):
        MultiStreamRecognizer(sr, 2, mesh=object())
    with pytest.raises(ValueError, match="'data'"):
        MultiStreamRecognizer(sr, 2, mesh=one_rank_mesh(tmp_path, ("x",)))
    raw = synth.synth_audio(np.random.default_rng(1), 6000).astype(
        "<i2").tobytes()
    got = []
    for mesh in (one_rank_mesh(tmp_path), None):
        ms = MultiStreamRecognizer(sr, 2, mesh=mesh)
        for i in range(2):
            ms.process(i, raw[: 4000 * (i + 1)])
        got.append(ms.finish())
    assert got[0] == got[1] and any(got[0])
    kws = SpeechRec(synth.write_kws_package(tmp_path / "kws", "tiny"),
                    device="cpu")
    with pytest.raises(ValueError, match="MultiStreamKWS"):
        MultiStreamRecognizer(kws, 2)
