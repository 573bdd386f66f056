"""The port's twins of ``examples/`` (``phnrec_tpu_torch/examples/``)
against the JAX originals, in process, on the CPU (``--device cpu``, the
kernels' plain versions), on synthetic ``"tiny"`` packages and seeded
audio.  Each original is loaded from ``examples/`` with importlib and run
with a patched ``sys.argv``; both print to the captured stdout.

* batch_decode: the .rec files equal in names and boundaries, scores
  within TOL_SCORE (log-posteriors differ by a few 1e-5, as in the
  pipeline tests); the printed lines equal.
* streaming_decode: the printed lines equal (settled labels, final).
* multistream_serving: the labels of a phoneme-loop package equal in
  names and boundaries, scores within TOL_SCORE; ``--mesh`` at world size
  1 on gloo prints what the run without it prints, and so does rank 0 of
  two gloo ranks under a launcher's environment.  On the KWS package
  the twin's hits equal the port's MultiStreamKWS fed the same chunks,
  and JAX's in keywords, order, start times and scores (within
  TOL_SCORE); their end times follow the posteriors' last bit (LRTrace,
  ROADMAP.md Queue 3), so they are not compared.
* keyword_spotting: fed JAX's posteriors, the twin's decoder chain
  prints the original's lines exactly; on its own posteriors, those are
  within TOL_POST of JAX's.
* train_gmm_hmm: each iteration's log-likelihood within 1e-4 relative,
  the written MMFs' means within 1e-4."""

import importlib.util
import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from phnrec_tpu_torch import synth
from phnrec_tpu_torch.examples import (batch_decode, keyword_spotting,
                                       multistream_serving, split_device,
                                       streaming_decode, train_gmm_hmm)
from phnrec_tpu_torch.io.labels import read_rec
from phnrec_tpu_torch.io.mmf import parse_mmf
from phnrec_tpu_torch.multistream import MultiStreamKWS
from phnrec_tpu_torch.pipeline import SpeechRec

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples"
TOL_SCORE = 2e-3
TOL_POST = 1e-4
REL_LL = 1e-4
TOL_MEANS = 1e-4


def _original(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_original(name, args, monkeypatch, capsys):
    mod = _original(name)
    capsys.readouterr()
    with monkeypatch.context() as m:
        m.setattr(sys, "argv", [f"{name}.py", *args])
        mod.main()
    return capsys.readouterr().out.splitlines()


def _run_twin(module, args, capsys):
    capsys.readouterr()
    assert module.main(["--device", "cpu", *args]) == 0
    return capsys.readouterr().out.splitlines()


def _rec_key(lines):
    """(names and boundaries, scores) of .rec lines."""
    labels = read_rec(lines)
    return ([(l.start_frames, l.end_frames, l.name) for l in labels],
            np.array([l.score for l in labels]))


def _assert_recs_match(got_lines, want_lines):
    gk, gs = _rec_key(got_lines)
    wk, ws = _rec_key(want_lines)
    assert gk == wk and gk
    np.testing.assert_allclose(gs, ws, rtol=0, atol=TOL_SCORE)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("examples")
    kws = synth.write_kws_package(root / "kws", "tiny", seed=0)
    # the original reads PKG/dicts/phonemes, BUT's packages' place for
    # the phoneme list; the synthetic package keeps it where its config
    # points
    (Path(kws) / "dicts").mkdir()
    (root / "audio").mkdir()
    shutil.copy(Path(kws) / "phonemes", Path(kws) / "dicts" / "phonemes")
    return dict(
        phn=synth.write_lcrc_package(root / "phn", "tiny", seed=0),
        stream=synth.write_lcrc_package(root / "stream", "tiny", seed=0,
                                        sent_norm=False),
        kws=kws,
        audio=synth.write_audio_files(root / "audio", 3, (1.5, 4.0),
                                      seed=5))


def test_split_device():
    assert split_device(["a", "b"]) == ("cuda", ["a", "b"])
    assert split_device(["a", "--device", "cpu", "b"]) == ("cpu",
                                                           ["a", "b"])
    assert split_device(["--device", "cuda:1", "a"]) == ("cuda:1", ["a"])


@pytest.mark.parametrize("module", [batch_decode, streaming_decode,
                                    keyword_spotting, multistream_serving])
def test_usage_without_arguments(module, capsys):
    assert module.main(["--device", "cpu"]) == 1
    assert "python -m phnrec_tpu_torch.examples." in capsys.readouterr().out


def test_batch_decode(data, tmp_path, monkeypatch, capsys):
    want = _run_original("batch_decode", [data["phn"], str(tmp_path / "j"),
                                          *data["audio"]],
                         monkeypatch, capsys)
    got = _run_twin(batch_decode, [data["phn"], str(tmp_path / "t"),
                                   *data["audio"]], capsys)
    assert [l.replace(str(tmp_path / "t"), "OUT") for l in got] == \
        [l.replace(str(tmp_path / "j"), "OUT") for l in want]
    assert len(got) == len(data["audio"])
    for p in data["audio"]:
        name = Path(p).stem + ".rec"
        _assert_recs_match(open(tmp_path / "t" / name).read().splitlines(),
                           open(tmp_path / "j" / name).read().splitlines())


@pytest.mark.parametrize("chunk_ms", [None, "130"])
def test_streaming_decode(data, chunk_ms, monkeypatch, capsys):
    args = [data["stream"], data["audio"][0]] + ([chunk_ms] if chunk_ms
                                                 else [])
    want = _run_original("streaming_decode", args, monkeypatch, capsys)
    got = _run_twin(streaming_decode, args, capsys)
    assert got == want
    assert got[-1].startswith("final: ") and len(got[-1]) > 8
    assert any("[settled]" in l for l in got)


def _streams(lines):
    """{path: [.rec lines]} of multistream_serving's output."""
    out, cur = {}, None
    for line in lines:
        if line.startswith("# sharding"):
            continue
        if line.startswith("# "):
            cur = out.setdefault(line[2:], [])
        else:
            cur.append(line)
    return out


def test_multistream_phoneme_package(data, tmp_path, monkeypatch, capsys):
    args = [data["stream"], *data["audio"]]
    want = _streams(_run_original("multistream_serving", args, monkeypatch,
                                  capsys))
    got_lines = _run_twin(multistream_serving, args, capsys)
    got = _streams(got_lines)
    assert list(got) == list(want) == data["audio"]
    for p in data["audio"]:
        _assert_recs_match(got[p], want[p])
    # one process over a FileStore, world size 1 on gloo
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    meshed = _run_twin(multistream_serving, ["--mesh", *args], capsys)
    assert meshed[0] == f"# sharding {len(data['audio'])} streams over 1 " \
        "devices"
    assert meshed[1:] == got_lines


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@pytest.mark.parametrize("n_streams", [2, 3])
def test_multistream_mesh_two_ranks(data, n_streams):
    """Under a launcher's environment (env://, 2 gloo ranks): rank 0
    prints every stream's labels as one process does, rank 1 nothing;
    with 3 streams only rank 0 serves (the most ranks that divide the
    stream count)."""
    args = [data["stream"], *data["audio"][:n_streams]]
    cmd = [sys.executable, "-m",
           "phnrec_tpu_torch.examples.multistream_serving", "--device",
           "cpu"]
    env = dict(os.environ, MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), WORLD_SIZE="2")
    procs = [subprocess.Popen(cmd + ["--mesh", *args], cwd=REPO,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs[0][1] + outs[1][1]
    env.pop("WORLD_SIZE")
    one = subprocess.run(cmd + args, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    served = 2 if n_streams % 2 == 0 else 1
    assert outs[0][0].splitlines() == [
        f"# sharding {n_streams} streams over {served} devices",
        *one.stdout.splitlines()]
    assert outs[1][0] == ""


def test_multistream_kws_package(data, monkeypatch, capsys):
    args = [data["kws"], *data["audio"]]
    want = _streams(_run_original("multistream_serving", args, monkeypatch,
                                  capsys))
    got_lines = _run_twin(multistream_serving, args, capsys)
    got = _streams(got_lines)
    assert list(got) == list(want) == data["audio"]
    # the server itself, fed the same interleaved chunks
    sr = SpeechRec(data["kws"], device="cpu")
    ms = MultiStreamKWS(sr, n_streams=len(data["audio"]))
    raw = [open(p, "rb").read() for p in data["audio"]]
    for o in range(0, max(map(len, raw)), 64 * 1024):
        for i, d in enumerate(raw):
            if o < len(d):
                ms.process(i, d[o: o + 64 * 1024])
            else:
                ms.end_stream(i)
    res = ms.finish()
    for p, labels in zip(data["audio"], res):
        assert _rec_key(got[p])[0] == _rec_key(
            [f"{l.start_frames}00000 {l.end_frames}00000 {l.name} "
             f"{l.score:f}" for l in labels])[0]
    assert any(got.values())
    # against JAX: the same hits in the same order, starts and scores;
    # the end times are free (LRTrace)
    for p in data["audio"]:
        (gk, gs), (wk, ws) = _rec_key(got[p]), _rec_key(want[p])
        assert [(s, n) for s, _, n in gk] == [(s, n) for s, _, n in wk]
        np.testing.assert_allclose(gs, ws, rtol=0, atol=TOL_SCORE)


KEYWORDS = [f"{w}={p}" for w, p in synth.KEYWORDS["tiny"].items()]


def test_keyword_spotting(data, monkeypatch, capsys):
    args = [data["kws"], data["audio"][1], *KEYWORDS]
    mod = _original("keyword_spotting")
    from phnrec_tpu.pipeline import SpeechRec as JSpeechRec
    seen = {}
    orig = JSpeechRec.process_offline

    def record(self, *a):
        seen["post"] = np.asarray(orig(self, *a))
        return seen["post"]

    capsys.readouterr()
    with monkeypatch.context() as m:
        m.setattr(sys, "argv", ["keyword_spotting.py", *args])
        m.setattr(JSpeechRec, "process_offline", record)
        mod.main()
    want = capsys.readouterr().out.splitlines()

    # the twin's decoder chain on JAX's posteriors: the same lines
    mine = {}
    with monkeypatch.context() as m:
        m.setattr(SpeechRec, "process_offline",
                  lambda self, *a: seen["post"])
        got = _run_twin(keyword_spotting, args, capsys)
    assert got == want and got != ["no keyword candidates"]
    # on its own posteriors
    torig = SpeechRec.process_offline

    def record_t(self, *a):
        mine["post"] = torig(self, *a)
        return mine["post"]

    with monkeypatch.context() as m:
        m.setattr(SpeechRec, "process_offline", record_t)
        own = _run_twin(keyword_spotting, args, capsys)
    np.testing.assert_allclose(mine["post"], seen["post"], rtol=0,
                               atol=TOL_POST)
    assert own


def _iters(lines):
    return [float(l.split()[4]) for l in lines if l.startswith("iter ")]


def test_train_gmm_hmm(tmp_path, monkeypatch, capsys):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    with monkeypatch.context() as m:
        m.chdir(tmp_path / "j")
        want = _run_original("train_gmm_hmm", ["3"], monkeypatch, capsys)
    with monkeypatch.context() as m:
        m.chdir(tmp_path / "t")
        got = _run_twin(train_gmm_hmm, ["3"], capsys)
    lj, lt = _iters(want), _iters(got)
    assert len(lt) == len(lj) == 3
    np.testing.assert_allclose(lt, lj, rtol=REL_LL)
    assert all(b >= a for a, b in zip(lt, lt[1:]))
    assert got[-3] == want[-3] == "wrote trained.mmf"
    mj = parse_mmf(str(tmp_path / "j" / "trained.mmf"))
    mt = parse_mmf(str(tmp_path / "t" / "trained.mmf"))
    for name in ("hi", "lo"):
        for a, b in zip(mt.hmms[name].gmm_states, mj.hmms[name].gmm_states):
            np.testing.assert_allclose(a.means, b.means, rtol=0,
                                       atol=TOL_MEANS)
