"""The port's copied host loaders give the same values as phnrec_tpu's on a
synthetic model package: config table, .nbin round trip, windows, phoneme
list, A-law table, waveform conversion, HTK features and rec/MLF text."""

import dataclasses
import os

import numpy as np
import pytest

from phnrec_tpu import config as jconfig
from phnrec_tpu.io import audio as jaudio
from phnrec_tpu.io import htk as jhtk
from phnrec_tpu.io import labels as jlabels
from phnrec_tpu.io import weights as jweights
from phnrec_tpu.utils import filename as jfilename

from phnrec_tpu_torch import config as tconfig
from phnrec_tpu_torch import synth
from phnrec_tpu_torch.io import audio as taudio
from phnrec_tpu_torch.io import htk as thtk
from phnrec_tpu_torch.io import labels as tlabels
from phnrec_tpu_torch.io import weights as tweights
from phnrec_tpu_torch.utils import filename as tfilename


@pytest.fixture(scope="module")
def pkg(tmp_path_factory):
    return synth.write_lcrc_package(tmp_path_factory.mktemp("io_pkg"),
                                    "tiny", seed=1)


def test_config_table_and_package(pkg):
    assert [dataclasses.astuple(v) for v in tconfig.CONFIG_VARIABLES] == \
        [dataclasses.astuple(v) for v in jconfig.CONFIG_VARIABLES]
    assert tconfig.PhnRecConfig.load_package(pkg).entries == \
        jconfig.PhnRecConfig.load_package(pkg).entries


@pytest.mark.parametrize("net", ["band0", "band1", "merger"])
def test_nbin_round_trip(pkg, net, tmp_path):
    path = os.path.join(pkg, "weights", f"{net}.nbin")
    a, b = jweights.load_nbin(path), tweights.load_nbin(path)
    for f in ("w1", "b1", "w2", "b2", "mean", "dev"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    out = str(tmp_path / "copy.nbin")
    tweights.save_nbin(out, b)
    assert open(out, "rb").read() == open(path, "rb").read()


def test_windows_and_phonemes(pkg):
    for i in range(2):
        path = os.path.join(pkg, "windows", f"band{i}.window")
        assert np.array_equal(tweights.load_window(path, 16),
                              jweights.load_window(path, 16))
    path = os.path.join(pkg, "phonemes")
    assert tweights.load_phoneme_list(path) == \
        jweights.load_phoneme_list(path)


def test_alaw_table():
    assert np.array_equal(taudio.ALAW_TABLE_D5, jaudio.ALAW_TABLE_D5)
    assert taudio.ALAW_TABLE_D5.dtype == jaudio.ALAW_TABLE_D5.dtype


@pytest.mark.parametrize("fmt", ["lin16", "alaw"])
@pytest.mark.parametrize("kw", [{}, {"scale": 0.5, "dc_shift": 3.25},
                                {"noise_level": 2.0}])
@pytest.mark.parametrize("n", [150, 4001])
def test_convert_waveform(fmt, kw, n):
    raw = np.random.default_rng(n).integers(
        0, 256, size=2 * n if fmt == "lin16" else n, dtype=np.uint8).tobytes()
    a, na = jaudio.convert_waveform(raw, fmt, **kw)
    b, nb = taudio.convert_waveform(raw, fmt, **kw)
    assert na == nb
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_htk_round_trip(tmp_path):
    mat = np.random.default_rng(0).standard_normal((7, 5)).astype(np.float32)
    p1, p2 = str(tmp_path / "a.htk"), str(tmp_path / "b.htk")
    jhtk.write_htk(p1, mat)
    thtk.write_htk(p2, mat)
    assert open(p1, "rb").read() == open(p2, "rb").read()
    a, b = jhtk.read_htk(p1), thtk.read_htk(p1)
    assert np.array_equal(a[0], b[0]) and a[1:] == b[1:]


def test_rec_and_mlf_text(tmp_path):
    labs = [(0, 12, "ph00", -3.5), (12, 40, "ph02", -17.125),
            (40, 41, "ph01", 0.0)]
    jl = [jlabels.Label(*x) for x in labs]
    tl = [tlabels.Label(*x) for x in labs]
    for mlf_style in (False, True):
        assert [tlabels.format_rec_line(l, mlf_style) for l in tl] == \
            [jlabels.format_rec_line(l, mlf_style) for l in jl]
    jlabels.write_rec(str(tmp_path / "a.rec"), jl)
    tlabels.write_rec(str(tmp_path / "b.rec"), tl)
    assert (tmp_path / "a.rec").read_text() == (tmp_path / "b.rec").read_text()
    with jlabels.MLFWriter(str(tmp_path / "a.mlf")) as m:
        m.add("*/x.rec", jl)
        m.add("*/y.rec", [])
    with tlabels.MLFWriter(str(tmp_path / "b.mlf")) as m:
        m.add("*/x.rec", tl)
        m.add("*/y.rec", [])
    assert (tmp_path / "a.mlf").read_text() == (tmp_path / "b.mlf").read_text()
    got = tlabels.read_mlf(str(tmp_path / "a.mlf"))
    want = jlabels.read_mlf(str(tmp_path / "a.mlf"))
    assert {k: [dataclasses.astuple(l) for l in v] for k, v in got.items()} \
        == {k: [dataclasses.astuple(l) for l in v] for k, v in want.items()}


@pytest.mark.parametrize("name", ["a/b/c.wav", "c.wav", "dir.x/noext",
                                  "back\\slash.raw", "plain"])
def test_filename(name):
    assert tfilename.change_file_suffix(name, "rec") == \
        jfilename.change_file_suffix(name, "rec")
    assert tfilename.change_file_path(name, "*") == \
        jfilename.change_file_path(name, "*")
    assert tfilename.cut_off_file_suffix(name) == \
        jfilename.cut_off_file_suffix(name)
    assert tfilename.extract_file_name(name) == \
        jfilename.extract_file_name(name)
