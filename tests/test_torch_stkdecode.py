"""Offline STK-network decoding in the port against phnrec_tpu: the
decode-mode labels of ``StkNetworkDecoder.decode`` / ``decode_batch``
(names and boundaries equal, scores within 1e-4) and the KWS-mode hits
(equal) on identical log-posteriors, the host KWS tracker, and
``SpeechRec(device="cpu")`` on synthetic stkint packages through
``process_file_list``, ``process_offline`` and the CLI's ``-l/-m`` and
``-i/-o`` against ``phnrec_tpu.SpeechRec`` (label keys equal, scores
within 1e-3, as tests/test_torch_pipeline.py holds the phoneme loop)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from phnrec_tpu import cli as jcli
from phnrec_tpu.decoder import stknet as jst
from phnrec_tpu.pipeline import SpeechRec as JSpeechRec

from phnrec_tpu_torch import synth
from phnrec_tpu_torch.decoder import stknet as tst
from phnrec_tpu_torch.io.labels import read_mlf, read_rec
from phnrec_tpu_torch.pipeline import SpeechRec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LENGTHS = [24000, 17003, 9001, 3000]
# the CLI and file lists decode the port's own log-posteriors, within
# 2.5e-4 of JAX's (tests/test_torch_pipeline.py): path scores sum them over
# up to 300 frames, as the phoneme loop's labels do
TOL_PIPE = 1e-3
# identical log-posteriors: the same float32 records; label scores are
# differences of two of them in double
TOL_SAME = 1e-4


def _key(labels):
    return [(l.start_frames, l.end_frames, l.name) for l in labels]


def _decode_mode(pkg):
    """The KWS package as a decode-mode word network.  A positive word
    penalty makes the best paths cross keyword edges (on random weights
    the filler loop, which carries no words, wins at -4.6875), so the
    labels hold words, word-time resets and multi-word paths."""
    cfg = os.path.join(pkg, "config")
    with open(cfg) as f:
        text = f.read()
    with open(cfg, "w") as f:
        f.write(text.replace("mode=kws", "mode=decode").replace(
            "wpenalty=-4.6875", "wpenalty=8.0"))
    return pkg


@pytest.fixture(scope="module")
def pkgs(tmp_path_factory):
    root = tmp_path_factory.mktemp("stk")
    return {
        "phnloop": synth.write_stk_decode_package(root / "loop", "tiny",
                                                  seed=0),
        "words": _decode_mode(synth.write_kws_package(root / "words", "tiny",
                                                      seed=1)),
        "kws": synth.write_kws_package(root / "kws", "tiny", seed=2),
    }


@pytest.fixture(scope="module")
def decoders(pkgs):
    return {k: (JSpeechRec(p), SpeechRec(p, device="cpu"))
            for k, p in pkgs.items()}


def _log_post(n_out, B, T, seed):
    rng = np.random.default_rng(seed)
    return np.log(rng.dirichlet(np.full(n_out, 0.3), size=(B, T))).astype(
        np.float32)


@pytest.mark.parametrize("which", ["phnloop", "words"])
def test_decode_mode_labels_on_identical_log_posteriors(decoders, which):
    """decode_batch over a ragged batch and decode of single rows: the
    same labels as phnrec_tpu's, multi-word closure edges included."""
    jsr, sr = decoders[which]
    jd, td = jsr.stk_decoder, sr.stk_decoder
    assert jd.mode == td.mode == "decode"
    D = sr.estimator.merger.n_out
    lp = _log_post(D, 5, 90, seed=3)
    nv = np.asarray([90, 61, 2, 77, 33], np.int32)
    want = jd.decode_batch(lp, nv)
    got = td.decode_batch(torch.from_numpy(lp), nv)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert _key(g) == _key(w)
        np.testing.assert_allclose([l.score for l in g],
                                   [l.score for l in w], rtol=0,
                                   atol=TOL_SAME)
    assert sum(map(len, got)) > 5
    one = td.decode(lp[1, :61])              # an array: on td.device
    assert _key(one) == _key(jd.decode(lp[1, :61])) == _key(got[1])
    if which == "words":
        names = {l.name for row in got for l in row}
        assert names & {"alpha", "beta"}, names


def test_kws_hits_on_identical_log_posteriors(decoders):
    jsr, sr = decoders["kws"]
    jd, td = jsr.stk_decoder, sr.stk_decoder
    assert jd.mode == td.mode == "kws"
    D = sr.estimator.merger.n_out
    lp = _log_post(D, 4, 150, seed=5)
    nv = np.asarray([150, 97, 1, 140], np.int32)
    want = jd.decode_batch(lp, nv)
    got = td.decode_batch(torch.from_numpy(lp), nv)
    full = [[(l.start_frames, l.end_frames, l.name, l.score) for l in row]
            for row in got]
    assert full == [[(l.start_frames, l.end_frames, l.name, l.score)
                     for l in row] for row in want]
    assert sum(map(len, got)) > 3
    assert td.decode(torch.from_numpy(lp[3, :140])) == got[3]
    # the per-frame KWS values of one utterance
    for g, w in zip(td.decoder.kws_scan(torch.from_numpy(lp[1, :97])),
                    jd.decoder.kws_scan(lp[1, :97])):
        assert g.dtype == np.asarray(w).dtype and np.array_equal(g, w)


def test_kws_tracker_matches_jax():
    """The host tracker on seeded sink values with ties, in chunks,
    with time pruning and a score floor: the same hits."""
    rng = np.random.default_rng(9)
    F, K = 400, 3
    wv = -rng.integers(0, 40, (F, K)).astype(np.float32) / 4
    fl = -rng.integers(0, 40, F).astype(np.float32) / 4
    wv[rng.random((F, K)) < 0.05] = jst.NEG
    st = np.sort(rng.integers(0, F, (F, K)), axis=0).astype(np.int32)
    kws = ["a", "b", "c"]
    for tp, sp in ((1e9, -np.inf), (40, -3.0)):
        j = jst.KWSTracker(kws, tp, sp)
        t = tst.KWSTracker(kws, tp, sp)
        for lo, hi in ((0, 150), (150, 151), (151, F)):
            jh = j.feed(wv[lo:hi], fl[lo:hi], st[lo:hi])
            th = t.feed(wv[lo:hi], fl[lo:hi], st[lo:hi])
            assert [vars(h) for h in th] == [vars(h) for h in jh]
        assert [vars(h) for h in t.finish()] == [vars(h) for h in j.finish()]
        assert [vars(h) for h in t.hits] == [vars(h) for h in j.hits]
        assert t.hits
        assert [vars(h) for h in tst.kws_candidates(wv, fl, st, kws, tp, sp)] \
            == [vars(h) for h in jst.kws_candidates(wv, fl, st, kws, tp, sp)]


def _write_waves(root):
    rng = np.random.default_rng(1)
    paths = []
    os.makedirs(root, exist_ok=True)
    for i, n in enumerate(LENGTHS):
        p = os.path.join(root, f"u{i}.raw")
        with open(p, "wb") as f:
            f.write(synth.synth_audio(rng, n).astype("<i2").tobytes())
        paths.append(p)
    return paths


def _assert_close_labels(got, want):
    assert _key(got) == _key(want)
    np.testing.assert_allclose([l.score for l in got],
                               [l.score for l in want], rtol=0,
                               atol=TOL_PIPE)


@pytest.mark.parametrize("which", ["phnloop", "words"])
def test_speechrec_file_list_and_cli(pkgs, decoders, which, tmp_path):
    """Decode mode: process_file_list (MLF) and the CLI's -l/-m on the CPU
    against phnrec_tpu's CLI; process_offline of one file."""
    jsr, sr = decoders[which]
    paths = _write_waves(str(tmp_path / "wav"))
    lst = tmp_path / "list.scp"
    lst.write_text("".join(p + "\n" for p in paths))
    jmlf, tmlf, cmlf = (str(tmp_path / n) for n in
                        ("jax.mlf", "torch.mlf", "cli.mlf"))
    assert jcli.main(["-c", pkgs[which], "-l", str(lst), "-m", jmlf]) == 0
    sr.process_file_list("wf", "str", str(lst), tmlf)
    proc = subprocess.run(
        [sys.executable, "-m", "phnrec_tpu_torch.cli", "-c", pkgs[which],
         "-l", str(lst), "-m", cmlf, "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    want = read_mlf(jmlf)
    assert len(want) == len(paths)
    assert sum(map(len, want.values())) > 0
    for got in (read_mlf(tmlf), read_mlf(cmlf)):
        assert list(got) == list(want)
        for name in want:
            _assert_close_labels(got[name], want[name])
    raw = open(paths[1], "rb").read()
    _assert_close_labels(sr.process_offline("wf", "str", raw).labels,
                         jsr.process_offline("wf", "str", raw).labels)


def test_kws_file_list_hits_on_the_ports_log_posteriors(pkgs, decoders,
                                                       tmp_path,
                                                       monkeypatch):
    """KWS mode through process_file_list and process_offline: each batch's
    hits equal phnrec_tpu's decoder on the same log-posteriors (hit end
    times follow the posteriors' last bit, so independently computed ones
    are not compared), and the CLI's MLF is process_file_list's."""
    jsr, sr = decoders["kws"]
    seen = []
    decode_batch = sr.stk_decoder.decode_batch

    def spy(lp, n_frames):
        out = decode_batch(lp, n_frames)
        seen.append((lp.numpy().copy(), np.asarray(n_frames), out))
        return out

    monkeypatch.setattr(sr.stk_decoder, "decode_batch", spy)
    paths = _write_waves(str(tmp_path / "wav"))
    lst = tmp_path / "list.scp"
    lst.write_text("".join(p + "\n" for p in paths))
    tmlf, cmlf = str(tmp_path / "torch.mlf"), str(tmp_path / "cli.mlf")
    sr.process_file_list("wf", "str", str(lst), tmlf)
    one = sr.process_offline("wf", "str", open(paths[0], "rb").read())
    assert one.labels == seen[-1][2][0]
    for lp, nv, out in seen:
        want = jsr.stk_decoder.decode_batch(lp, nv)
        assert [[vars(l) for l in row] for row in out] == \
            [[vars(l) for l in row] for row in want]
    got = read_mlf(tmlf)
    assert len(got) == len(paths)
    assert sum(map(len, got.values())) == sum(
        len(row) for _, _, out in seen[:-1] for row in out) > 0
    proc = subprocess.run(
        [sys.executable, "-m", "phnrec_tpu_torch.cli", "-c", pkgs["kws"],
         "-l", str(lst), "-m", cmlf, "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert open(cmlf).read() == open(tmlf).read()


def test_cli_single_file(pkgs, tmp_path):
    """-i/-o writes one .rec file, the same as phnrec_tpu's."""
    path = _write_waves(str(tmp_path / "wav"))[0]
    jrec, trec = str(tmp_path / "j.rec"), str(tmp_path / "t.rec")
    assert jcli.main(["-c", pkgs["phnloop"], "-i", path, "-o", jrec]) == 0
    proc = subprocess.run(
        [sys.executable, "-m", "phnrec_tpu_torch.cli", "-c",
         pkgs["phnloop"], "-i", path, "-o", trec, "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    got, want = read_rec(trec), read_rec(jrec)
    assert want
    _assert_close_labels(got, want)
