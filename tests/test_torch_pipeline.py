"""The port's batch wav->rec path against phnrec_tpu on the tiny synthetic
package, for lin16 and A-law: (a) the log-posteriors of _post_core within
a measured tolerance, (b) the port's decoder on JAX's log-posteriors gives
JAX's labels, (c) end-to-end BatchPipeline labels and the CLI's MLF equal."""

import os
import subprocess
import sys
from dataclasses import astuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phnrec_tpu import cli as jcli
from phnrec_tpu.parallel.batch import BatchPipeline as JBatch
from phnrec_tpu.pipeline import SpeechRec as JSpeechRec

from phnrec_tpu_torch import synth
from phnrec_tpu_torch.decoder import phnloop as tpl
from phnrec_tpu_torch.io.labels import read_mlf
from phnrec_tpu_torch.pipeline import SpeechRec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LENGTHS = [24000, 17003, 9001, 150]       # ragged, one shorter than a frame


def _key(labels):
    return [(l.start_frames, l.end_frames, l.name) for l in labels]


@pytest.fixture(scope="module", params=["lin16", "alaw"])
def case(request, tmp_path_factory):
    fmt = request.param
    root = tmp_path_factory.mktemp(f"pipe_{fmt}")
    pkg = synth.write_lcrc_package(root / "pkg", "tiny", seed=0, fmt=fmt)
    rng = np.random.default_rng(1)
    waves = [synth.synth_audio(rng, n) for n in LENGTHS]
    L = -(-max(LENGTHS) // 16000) * 16000
    if fmt == "lin16":
        wave = np.zeros((len(waves), L), np.int16)
        rows = waves
    else:
        wave = np.full((len(waves), L), 0x55, np.uint8)
        rows = [synth.alaw_encode(w.astype(np.float64)) for w in waves]
    for i, r in enumerate(rows):
        wave[i, : len(r)] = r
    n_samples = np.array(LENGTHS, np.int32)
    jsr = JSpeechRec(pkg)
    jbp = JBatch(jsr)
    n_frames = jbp.frame_counts(n_samples)
    max_frames = int(jsr.frontend.frame_count(L))
    ns = jnp.asarray(n_samples) if fmt == "alaw" else None
    jax_lp = np.asarray(jbp._post_core(jnp.asarray(wave),
                                       jnp.asarray(n_frames), max_frames, ns))
    return dict(fmt=fmt, root=root, pkg=pkg, rows=rows, wave=wave,
                n_samples=n_samples, n_frames=n_frames,
                max_frames=max_frames, jsr=jsr, jax_lp=jax_lp,
                jax_labels=jbp.run_padded(wave, n_samples).labels,
                sr=SpeechRec(pkg, device="cpu"))


def test_post_core_log_posteriors(case):
    bp = case["sr"].batch_pipeline
    n_frames, max_frames, want = (case["n_frames"], case["max_frames"],
                                  case["jax_lp"])
    w, nf, mf, ns_t = bp.to_device(case["wave"], case["n_samples"])
    assert mf == max_frames and np.array_equal(nf.numpy(), n_frames)
    got = bp._post_core(w, nf, mf, ns_t).numpy()
    assert got.shape == want.shape
    for b, n in enumerate(n_frames):
        # float32 GEMMs, sums and fexp steps through three nets, then ln:
        # measured max 6.1e-5 on log-posteriors down to -20 (lin16 and
        # A-law); padded frames are not compared
        np.testing.assert_allclose(got[b, :n], want[b, :n], rtol=0,
                                   atol=2.5e-4)


def test_decoder_on_jax_log_posteriors(case):
    sr, n_frames = case["sr"], case["n_frames"]
    hist = tpl.viterbi_scan_batch(sr.loop_spec,
                                  torch.tensor(case["jax_lp"]))
    segs = tpl.fetch_segments(tpl.backtrack_device(
        sr.loop_spec, hist, torch.from_numpy(n_frames)))
    got = tpl.labels_from_segments(segs, n_frames, sr.phonemes)
    # JAX's labels come from the same log-posteriors: all equal, scores
    # included
    assert [[astuple(l) for l in row] for row in got] == \
        [[astuple(l) for l in row] for row in case["jax_labels"]]
    assert any(len({l.name for l in row}) > 1 for row in got)


def test_batch_pipeline_labels(case):
    want = case["jax_labels"]
    got = case["sr"].batch_pipeline.run_padded(
        case["wave"], case["n_samples"]).labels
    for g, w in zip(got, want):
        assert _key(g) == _key(w)
        # scores sum log-posteriors over up to 300 frames: measured max
        # 1.8e-4
        np.testing.assert_allclose([l.score for l in g],
                                   [l.score for l in w], rtol=0, atol=1e-3)
    # a single file through process_offline (a batch of one)
    raw = case["rows"][1].tobytes() if case["fmt"] == "alaw" else \
        case["rows"][1].astype("<i2").tobytes()
    one = case["sr"].process_offline("wf", "str", raw).labels
    assert _key(one) == _key(case["jsr"].process_offline("wf", "str",
                                                         raw).labels)


def test_cli_mlf(case):
    root = case["root"]
    wav = root / "wav"
    wav.mkdir(exist_ok=True)
    paths = []
    for i, r in enumerate(case["rows"]):
        p = wav / f"u{i}.raw"
        p.write_bytes(r.astype("<i2").tobytes() if case["fmt"] == "lin16"
                      else r.tobytes())
        paths.append(str(p))
    lst = root / "list.scp"
    lst.write_text("".join(p + "\n" for p in paths))
    jmlf, tmlf = str(root / "jax.mlf"), str(root / "torch.mlf")
    assert jcli.main(["-c", case["pkg"], "-l", str(lst), "-m", jmlf]) == 0
    proc = subprocess.run(
        [sys.executable, "-m", "phnrec_tpu_torch.cli", "-c", case["pkg"],
         "-l", str(lst), "-m", tmlf, "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    want, got = read_mlf(jmlf), read_mlf(tmlf)
    assert list(got) == list(want) and len(got) == len(paths)
    for name in want:
        assert _key(got[name]) == _key(want[name])
        # as in test_batch_pipeline_labels
        np.testing.assert_allclose([l.score for l in got[name]],
                                   [l.score for l in want[name]], rtol=0,
                                   atol=1e-3)
    # the text differs at most in a score's last printed digits
    jl = open(jmlf).read().splitlines()
    tl = open(tmlf).read().splitlines()
    assert [l.rsplit(" ", 1)[0] for l in tl] == \
        [l.rsplit(" ", 1)[0] for l in jl]


def test_unported_paths_raise(tmp_path, monkeypatch, capsys):
    """Every path of the port runs: no module raises NotImplementedError,
    and the CLI's -a, -f, --profile, --trace and --alize, which the port
    once refused, now decode."""
    import io
    import re

    from phnrec_tpu_torch import cli
    pkg_root = os.path.join(REPO, "phnrec_tpu_torch")
    for root, _, files in os.walk(pkg_root):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(root, f)).read()
                assert not re.search(r"raise NotImplementedError", src), f
    pkg = synth.write_lcrc_package(tmp_path / "pkg", "tiny", seed=4)
    sr = SpeechRec(pkg, device="cpu")
    # the staged pairs are ported (tests/test_torch_staged.py)
    par = sr.process_offline("wf", "par", b"\0\0" * 400)
    assert par.shape == (3, sr.frontend.n_params)
    assert sr.process_offline("wf", "post", b"\0\0" * 400).shape[0] == 3
    assert isinstance(sr.process_offline("par", "str", par).labels, list)
    raw = synth.synth_audio(np.random.default_rng(3), 12000).astype(
        "<i2").tobytes()
    (tmp_path / "x.raw").write_bytes(raw)
    x = str(tmp_path / "x.raw")

    class Stdin:
        buffer = io.BytesIO(raw)
    monkeypatch.setattr(sys, "stdin", Stdin())
    capsys.readouterr()
    assert cli.main(["-c", pkg, "-a", "-f", "lab", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    from phnrec_tpu_torch.live import run_live
    want = []
    run_live(sr, out_format="lab", source=x, emit=want.append)
    assert lines == want and want
    for argv in (["-i", x, "-o", str(tmp_path / "p.rec"), "--profile"],
                 ["-i", x, "-o", str(tmp_path / "t.rec"),
                  "--trace=" + str(tmp_path / "d")],
                 ["-i", x, "-o", str(tmp_path / "v.vad"), "--alize"]):
        assert cli.main(["-c", pkg, "--device", "cpu"] + argv) == 0
    assert os.listdir(tmp_path / "d")
    assert "viterbi" in capsys.readouterr().err
    assert cli.main(["--alize"]) == 1          # no -c: the usual error
    # the other posterior systems and PLP are ported
    # (tests/test_torch_traps.py): an unknown frontend kind still raises
    cfg = os.path.join(pkg, "config")
    text = open(cfg).read()
    open(cfg, "w").write(text.replace("[melbanks]",
                                      "[params]\nkind=mfcc\n[melbanks]"))
    with pytest.raises(ValueError, match="params/kind"):
        SpeechRec(pkg, device="cpu")
    # an stkint package decodes its files offline (KWS mode: hits), single
    # files and lists alike; the phoneme-loop batch decode is not its
    # decoder
    kws = SpeechRec(synth.write_kws_package(tmp_path / "kws", "tiny"),
                    device="cpu")
    assert kws.stk_decoder is not None
    raw = synth.synth_audio(np.random.default_rng(2), 9000).astype(
        "<i2").tobytes()
    hits = kws.process_offline("wf", "str", raw).labels
    assert all(l.name in ("alpha", "beta") for l in hits)
    (tmp_path / "u.raw").write_bytes(raw)
    (tmp_path / "list.scp").write_text(
        f"{tmp_path / 'u.raw'} {tmp_path / 'u.rec'}\n")
    kws.process_file_list("wf", "str", str(tmp_path / "list.scp"))
    assert [l.split()[2] for l in open(tmp_path / "u.rec")] == \
        [l.name for l in hits]
    with pytest.raises(ValueError, match="STK network decoder"):
        kws.batch_pipeline.run_padded(np.zeros((1, 800), np.int16),
                                      np.array([800], np.int32))
