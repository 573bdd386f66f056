"""The port's auxiliary host modules against phnrec_tpu's: filmatch,
io.labels.MLFIndex, utils.stkio and utils.imagesc give equal results on
the same inputs."""

import sys

import numpy as np
import pytest

from phnrec_tpu.io.labels import MLFIndex as JMLFIndex
from phnrec_tpu.utils import filmatch as jfilmatch
from phnrec_tpu.utils import stkio as jstkio
from phnrec_tpu.utils.imagesc import imagesc as jimagesc

from phnrec_tpu_torch.io.labels import Label, MLFIndex, MLFWriter, read_mlf
from phnrec_tpu_torch.utils import filmatch, stkio
from phnrec_tpu_torch.utils.imagesc import imagesc

CASES = [("*/abc.lab", "dir/sub/abc.lab"), ("*.wav", "x.wav"),
         ("*.wav", "x.rec"), ("a?c", "abc"), ("a?c", "abcd"),
         ("%%%*", "spk1_utt7"), ("*_%%.lab", "a/b_42.lab"), ("abc", "abc"),
         ("abc", "abd"), ("[a-c]x", "bx"), ("[!a-c]x", "bx"), ("[a]", "[a]"),
         ("*%*", "xyz"), ("a\\*b", "a*b"), ("", ""), ("*", "")]


@pytest.mark.parametrize("pattern,text", CASES)
def test_filmatch_matches_jax(pattern, text):
    for htk in (True, False):
        try:
            want = jfilmatch.match(pattern, text, htk)
        except ValueError:
            with pytest.raises(ValueError):
                filmatch.match(pattern, text, htk)
            continue
        assert filmatch.match(pattern, text, htk) == want
        assert filmatch.fnmatch(pattern, text, htk) == \
            jfilmatch.fnmatch(pattern, text, htk)
        assert filmatch.is_pattern(pattern, htk) == \
            jfilmatch.is_pattern(pattern, htk)


def test_filmatch_seeded_random():
    rng = np.random.default_rng(0)
    alpha = "ab%?*"
    for _ in range(300):
        p = "".join(rng.choice(list(alpha), rng.integers(0, 6)))
        t = "".join(rng.choice(list("ab"), rng.integers(0, 6)))
        assert filmatch.match(p, t) == jfilmatch.match(p, t)


def test_mlf_index_matches_jax(tmp_path):
    mlf = str(tmp_path / "x.mlf")
    with MLFWriter(mlf) as w:
        w.add("*/utt1.rec", [Label(0, 10, "a", -1.0),
                             Label(10, 20, "b", -2.0)])
        w.add("*/utt2.rec", [Label(0, 5, "c", -0.5)])
        w.add("dir/utt3.rec", [Label(0, 7, "d", -0.25)])
        w.add("*/spk%%.rec", [Label(0, 3, "e", -0.125)])
    idx, jidx = MLFIndex(mlf), JMLFIndex(mlf)
    full = read_mlf(mlf)
    assert len(idx) == len(jidx) == 4 and idx.names() == jidx.names()
    for name in ("any/path/utt1.rec", "utt2", "utt3.rec", "x/spk42.rec",
                 *idx.names()):
        got = idx.get(name)
        assert [tuple(vars(l).values()) for l in got] == \
            [tuple(vars(l).values()) for l in jidx.get(name)]
        if name in full:
            assert got == full[name]
    assert "utt2" in idx and "nope.rec" not in idx
    with pytest.raises(KeyError):
        idx.get("nope.rec")


def test_stkio_matches_jax(tmp_path):
    f = tmp_path / "a.txt"
    f.write_text("hello\nworld\n")
    assert stkio.expand_filter_command("cat $ $", "x") == \
        jstkio.expand_filter_command("cat $ $", "x")
    for name, flt in ((str(f), None), (f"|cat {f}", None),
                      (str(f), "cat $")):
        with stkio.open_stream(name, "rb", flt) as a, \
                jstkio.open_stream(name, "rb", flt) as b:
            assert a.read() == b.read() == f.read_bytes()
    out = tmp_path / "b.txt"
    with stkio.open_stream(f"|cat > {out}", "w") as w:
        w.write("piped\n")
    assert out.read_text() == "piped\n"
    assert stkio.open_stream("-", "rb") is sys.stdin.buffer


@pytest.mark.parametrize("kw", [dict(title="t"), dict(max_rows=7,
                                                      max_cols=9),
                                dict(transform=np.log, color=True),
                                dict(color=True, max_rows=3)])
def test_imagesc_matches_jax(kw):
    a = np.abs(np.random.default_rng(1).standard_normal((40, 60))) + 1e-3
    assert imagesc(a, **kw) == jimagesc(a, **kw)
    assert imagesc(a[0], **kw) == jimagesc(a[0], **kw)
    with pytest.raises(ValueError):
        imagesc(np.zeros((2, 2, 2)))
