"""The port's native host library (native/, g++ into build/) against
phnrec_tpu's native module and the NumPy / Python routes: every binding
gives identical results, and the three call sites (waveform conversion,
score.align_counts, phnloop.backtrack_batch) give the same results on
either route."""

import os

import numpy as np
import pytest

from phnrec_tpu import native as jnative
from phnrec_tpu.decoder import phnloop as jphnloop

from phnrec_tpu_torch import native
from phnrec_tpu_torch.decoder import phnloop
from phnrec_tpu_torch.io import audio


def test_builds_into_build_dir():
    assert native.available()
    path = native.lib_path()
    assert path.exists() and path.parent.name == "phnrec_tpu_torch"
    assert path.parent.parent.name == "build"
    assert not any(f.endswith(".so") for f in
                   os.listdir(os.path.dirname(native.__file__)))


@pytest.mark.parametrize("fmt,scale,dc", [("lin16", 1.0, 0.0),
                                          ("lin16", 0.5, 2.0),
                                          ("alaw", 1.0, 0.0),
                                          ("alaw", 0.25, -3.0)])
def test_convert_waveform_matches(fmt, scale, dc, monkeypatch):
    rng = np.random.default_rng(1)
    for n in (3, 150, 4001):
        raw = rng.integers(0, 256, n * (2 if fmt == "lin16" else 1),
                           dtype=np.uint8).tobytes()
        w, k = native.convert_waveform(raw, fmt, scale, dc)
        jw, jk = jnative.convert_waveform(raw, fmt, scale, dc)
        assert k == jk == n and w.shape[0] == max(n, 200)
        np.testing.assert_array_equal(w, jw)
        # the port's audio.convert_waveform takes the native route; its
        # NumPy route gives the same array
        np.testing.assert_array_equal(
            audio.convert_waveform(raw, fmt, scale, dc)[0], w)
        monkeypatch.setattr(native, "available", lambda: False)
        np.testing.assert_array_equal(
            audio.convert_waveform(raw, fmt, scale, dc)[0], w)
        monkeypatch.undo()


def test_swap4_matches():
    a = np.random.default_rng(2).standard_normal(33).astype(np.float32)
    b, c = a.copy(), a.copy()
    native.swap4_inplace(b)
    jnative.swap4_inplace(c)
    assert b.tobytes() == c.tobytes() == a.astype(">f4").tobytes()


def test_align_matches():
    rng = np.random.default_rng(4)
    for _ in range(30):
        r = rng.integers(0, 3, rng.integers(0, 30)).astype(np.int32)
        h = rng.integers(0, 3, rng.integers(0, 30)).astype(np.int32)
        assert native.align(r, h) == jnative.align(r, h)


def test_myrand_matches():
    for seed in (1, 7, 12345):
        np.testing.assert_array_equal(native.myrand_sequence(seed, 50),
                                      jnative.myrand_sequence(seed, 50))


def _histories(seed, B=5, T=60, P=7):
    """Self-consistent [T, B] histories the way the scan writes them."""
    rng = np.random.default_rng(seed)
    max_phn = np.zeros((B, T), np.int8)
    ent = np.zeros((B, T), np.int32)
    for b in range(B):
        t = 0
        while t < T:
            seg = min(int(rng.integers(1, 8)), T - t)
            max_phn[b, t: t + seg] = int(rng.integers(0, P))
            ent[b, t: t + seg] = t
            t += seg
    alpha = np.cumsum(rng.standard_normal((B, T)).astype(np.float32), 1)
    n_frames = rng.integers(1, T + 1, B).astype(np.int32)
    return (phnloop.History(max_phn.T.copy(), ent.T.copy(), alpha.T.copy()),
            n_frames, [f"p{i}" for i in range(P)])


def _key(rows):
    return [[(l.start_frames, l.end_frames, l.name, l.score) for l in r]
            for r in rows]


@pytest.mark.parametrize("seed", range(4))
def test_backtrack_batch_routes_match(seed, monkeypatch):
    hist, n_frames, phonemes = _histories(seed)
    native_rows = phnloop.backtrack_batch(hist, n_frames, phonemes)
    # phnrec_tpu's per-row replay; its native route rounds each like to
    # float32, which the port's does not
    jrows = [jphnloop.backtrack(jphnloop.History(
        *(a[: n_frames[b], b] for a in hist)), phonemes)
        for b in range(len(n_frames))]
    assert _key(native_rows) == _key(jrows)
    jnat = jphnloop.backtrack_batch(jphnloop.History(*hist), n_frames,
                                    phonemes)
    for r, j in zip(native_rows, jnat):
        assert [l[:3] for l in _key([r])[0]] == [l[:3] for l in _key([j])[0]]
        np.testing.assert_allclose([l.score for l in r],
                                   [l.score for l in j], rtol=1e-6)
    monkeypatch.setattr(native, "available", lambda: False)
    python_rows = phnloop.backtrack_batch(hist, n_frames, phonemes)
    assert _key(python_rows) == _key(native_rows)
