"""The port's scoring (score.py) and VAD output (vad.py, the CLI's
--alize) against phnrec_tpu's: alignments and counts on seeded random
sequences (ties included), Scorer summaries and score_mlf equal exactly;
the CLI's ALIZE files equal phnrec_tpu's CLI's on one synthetic package."""

import numpy as np
import pytest

from phnrec_tpu import cli as jcli
from phnrec_tpu import score as jscore
from phnrec_tpu import vad as jvad
from phnrec_tpu.io.labels import Label as JLabel

from phnrec_tpu_torch import cli, native, score, synth, vad
from phnrec_tpu_torch.io.labels import Label, MLFWriter


def _seqs(seed, n_sym):
    rng = np.random.default_rng(seed)
    ref = [f"p{i}" for i in rng.integers(0, n_sym, rng.integers(0, 25))]
    hyp = [f"p{i}" for i in rng.integers(0, n_sym, rng.integers(0, 25))]
    return ref, hyp


@pytest.mark.parametrize("seed", range(12))
def test_align_matches_jax(seed):
    # two symbols make many equal-cost paths: the tie order is checked
    ref, hyp = _seqs(seed, 2 if seed % 2 else 6)
    counts, pairs = score.align(ref, hyp)
    jcounts, jpairs = jscore.align(ref, hyp)
    assert pairs == jpairs
    assert (counts.hits, counts.dels, counts.subs, counts.ins) == \
        (jcounts.hits, jcounts.dels, jcounts.subs, jcounts.ins)
    got = score.align_counts(ref, hyp)
    assert (got.hits, got.dels, got.subs, got.ins) == \
        (counts.hits, counts.dels, counts.subs, counts.ins)


def test_align_counts_both_routes(monkeypatch):
    """align_counts' native and Python routes agree on ties."""
    assert native.available()
    want = [score.align_counts(*_seqs(s, 2)) for s in range(20)]
    monkeypatch.setattr(native, "available", lambda: False)
    got = [score.align_counts(*_seqs(s, 2)) for s in range(20)]
    assert got == want


def test_scorer_and_score_mlf_match_jax(tmp_path):
    s, js = score.Scorer(), jscore.Scorer()
    for seed in range(8):
        ref, hyp = _seqs(100 + seed, 4)
        s.add(ref, hyp)
        js.add(ref, hyp)
    assert s.summary() == js.summary()
    ref_p, hyp_p = tmp_path / "ref.mlf", tmp_path / "hyp.mlf"
    with MLFWriter(str(ref_p)) as wr, MLFWriter(str(hyp_p)) as wh:
        for seed in range(6):
            ref, hyp = _seqs(200 + seed, 4)
            wr.add(f"*/u{seed}.rec",
                   [Label(i, i + 1, n, 0.0) for i, n in enumerate(ref)])
            wh.add(f"*/u{seed}.lab",
                   [Label(i, i + 1, n, 0.0) for i, n in enumerate(hyp)])
    got, want = score.score_mlf(str(ref_p), str(hyp_p)), \
        jscore.score_mlf(str(ref_p), str(hyp_p))
    assert got.summary() == want.summary() and got.n_utts == 6


def test_labels_to_alize_matches_jax():
    rng = np.random.default_rng(3)
    names = ["pau", "int", "spk", "a", "b"]
    t, labs = 0, []
    for _ in range(40):
        d = int(rng.integers(1, 30))
        labs.append((t, t + d, names[int(rng.integers(0, 5))],
                     float(rng.normal())))
        t += d
    got = vad.labels_to_alize([Label(*l) for l in labs])
    assert got == jvad.labels_to_alize([JLabel(*l) for l in labs])
    assert got and all(l.endswith(" speech") for l in got)


@pytest.fixture(scope="module")
def pkg(tmp_path_factory):
    root = tmp_path_factory.mktemp("alize")
    p = synth.write_lcrc_package(root / "pkg", "tiny", seed=5)
    rng = np.random.default_rng(5)
    files = []
    for i, n in enumerate([16000, 9000]):
        f = root / f"u{i}.raw"
        f.write_bytes(synth.synth_audio(rng, n).astype("<i2").tobytes())
        files.append(str(f))
    return p, files


def test_cli_alize_matches_jax(pkg, tmp_path):
    p, files = pkg
    n_lines = 0
    for i, f in enumerate(files):
        jo, to = tmp_path / f"j{i}.vad", tmp_path / f"t{i}.vad"
        assert jcli.main(["--alize", "-c", p, "-i", f, "-o", str(jo)]) == 0
        assert cli.main(["--alize", "-c", p, "-i", f, "-o", str(to),
                         "--device", "cpu"]) == 0
        assert to.read_text() == jo.read_text()
        n_lines = n_lines + len(to.read_text().splitlines())
    assert n_lines > 0
    # a list writes one file a source, and vad.main adds --alize itself
    lst = tmp_path / "l.scp"
    lst.write_text("".join(f"{f} {tmp_path / f'l{i}.vad'}\n"
                           for i, f in enumerate(files)))
    assert vad.main(["-c", p, "-l", str(lst), "--device", "cpu"]) == 0
    for i in range(len(files)):
        assert (tmp_path / f"l{i}.vad").read_text() == \
            (tmp_path / f"t{i}.vad").read_text()
