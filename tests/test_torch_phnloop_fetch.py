"""The phoneme loop's single-utterance wrappers (viterbi_scan, decode)
against phnrec_tpu's, the split device -> host fetch (fetch_segments_start
/ _finish: slots past ``cap``, the capacity assertion) against the one-call
fetch and phnrec_tpu's, and the list decode with batches in flight against
the serial decode of the same files."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phnrec_tpu.decoder import phnloop as jpl

from phnrec_tpu_torch import synth
from phnrec_tpu_torch.decoder import phnloop as tpl
from phnrec_tpu_torch.io.labels import read_mlf
from phnrec_tpu_torch.pipeline import SpeechRec


def _case(seed, T=64, P=7, S=3):
    rng = np.random.default_rng(seed)
    lp = np.log(rng.dirichlet(np.ones(P * S), size=T)).astype(np.float32)
    return (jpl.PhnLoopSpec(P, S, -2.5), tpl.PhnLoopSpec(P, S, -2.5), lp,
            [f"p{i}" for i in range(P)])


@pytest.mark.parametrize("seed", range(3))
def test_viterbi_scan_and_decode_match_jax(seed):
    jspec, tspec, lp, names = _case(seed, T=40 + 11 * seed)
    hist = tpl.viterbi_scan(tspec, torch.from_numpy(lp))
    jhist = jpl.viterbi_scan(jspec, jnp.asarray(lp))
    for g, w in zip(hist, jhist):
        assert g.shape == (lp.shape[0],)
        assert np.array_equal(g.numpy(), np.asarray(w))
    got = tpl.decode(tspec, torch.from_numpy(lp), names)
    want = jpl.decode(jspec, jnp.asarray(lp), names)
    assert [(l.start_frames, l.end_frames, l.name, l.score) for l in got] \
        == [(l.start_frames, l.end_frames, l.name, l.score) for l in want]


def _segments(seed, B=4, T=96):
    rng = np.random.default_rng(seed)
    _, tspec, _, names = _case(seed)
    lp = np.log(rng.dirichlet(np.ones(21), size=(B, T))).astype(np.float32)
    n_frames = rng.integers(3, T + 1, B).astype(np.int32)
    hist = tpl.viterbi_scan_batch(tspec, torch.from_numpy(lp))
    return (tpl.backtrack_device(tspec, hist, torch.from_numpy(n_frames)),
            n_frames, names, lp)


@pytest.mark.parametrize("cap", [1, 3, 128])
def test_fetch_start_finish_equal_one_call_and_jax(cap):
    segs, n_frames, names, lp = _segments(1)
    cmax = int(segs.count.max())
    pending = tpl.fetch_segments_start(segs, cap)
    # on CPU tensors the start is the slice and no event
    assert pending[2] is None
    assert pending[1].phn.shape[1] == min(cap, segs.phn.shape[1])
    got = tpl.fetch_segments_finish(pending)
    one = tpl.fetch_segments(segs, cap)
    jsegs = jpl.fetch_segments(jpl.Segments(
        *(jnp.asarray(a.numpy()) for a in segs)), cap)
    for a, b, c in zip(got, one, jsegs):
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert np.array_equal(a, np.asarray(c))
    # a row past cap refetches every slot
    assert got.phn.shape[1] == (segs.phn.shape[1] if cmax > cap
                                else min(cap, segs.phn.shape[1]))
    assert tpl.labels_from_segments(got, n_frames, names) == \
        tpl.labels_from_segments(tpl.fetch_segments(segs, 10 ** 6),
                                 n_frames, names)


def test_fetch_finish_keeps_capacity_assert():
    segs, *_ = _segments(2)
    full = tpl.Segments(torch.full_like(segs.count, segs.phn.shape[1]),
                        *segs[1:])
    pending = tpl.fetch_segments_start(full, cap=4)
    with pytest.raises(AssertionError, match="capacity overflow"):
        tpl.fetch_segments_finish(pending)


def test_list_decode_in_flight_equals_serial(tmp_path, monkeypatch):
    """Seven batches (max_batch 2 by a small list's buckets) go through
    the in-flight list decode; the MLF equals the one written by decoding
    each file alone, and at most three batches were ever pending."""
    pkg = synth.write_lcrc_package(tmp_path / "pkg", "tiny", seed=3)
    rng = np.random.default_rng(3)
    files = []
    for i in range(13):
        f = tmp_path / f"u{i:02d}.raw"
        f.write_bytes(synth.synth_audio(rng, int(rng.integers(3000, 40000)))
                      .astype("<i2").tobytes())
        files.append(str(f))
    (tmp_path / "l.scp").write_text("".join(f + "\n" for f in files))
    sr = SpeechRec(pkg, device="cpu")
    from phnrec_tpu_torch.parallel import loader
    orig = loader.PrefetchLoader.__init__

    def small(self, *a, **kw):
        kw["max_batch"] = 2
        orig(self, *a, **kw)
    monkeypatch.setattr(loader.PrefetchLoader, "__init__", small)
    starts, finishes, most = [], [], [0]
    o_start, o_finish = tpl.fetch_segments_start, tpl.fetch_segments_finish

    def start(*a, **kw):
        starts.append(1)
        most[0] = max(most[0], len(starts) - len(finishes))
        return o_start(*a, **kw)

    def finish(p):
        finishes.append(1)
        return o_finish(p)
    monkeypatch.setattr(tpl, "fetch_segments_start", start)
    monkeypatch.setattr(tpl, "fetch_segments_finish", finish)
    sr.process_file_list("wf", "str", str(tmp_path / "l.scp"),
                         str(tmp_path / "b.mlf"))
    assert len(starts) == len(finishes) >= 7 and most[0] == 3
    monkeypatch.undo()
    got = read_mlf(str(tmp_path / "b.mlf"))
    assert len(got) == len(files)
    for f, (name, labels) in zip(files, got.items()):
        want = sr.process_offline("wf", "str", open(f, "rb").read()).labels
        assert [(l.start_frames, l.end_frames, l.name) for l in labels] == \
            [(l.start_frames, l.end_frames, l.name) for l in want]
        np.testing.assert_allclose([l.score for l in labels],
                                   [l.score for l in want], atol=1e-3)
