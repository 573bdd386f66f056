"""The port's copy of io/features.py (HTK feature toolbox: kind codec,
compression, CRC, frame ranges, extension, derivatives, sentence CMN and
the cepstral-norm files) against phnrec_tpu's on the same files: every
read equal bit for bit, files written by one package read by the other."""

import numpy as np
import pytest

from phnrec_tpu.io import features as jf

from phnrec_tpu_torch.io import features as tf


def test_param_kind_codec_matches():
    for s in ("MFCC", "MFCC_0_D_A", "FBANK_Z", "PLP_E_D_A_T", "USER_C",
              "FBANK_D_A_K", "LPC_N_E_D"):
        code = tf.parse_param_kind(s)
        assert code == jf.parse_param_kind(s)
        assert tf.param_kind_to_str(code) == jf.param_kind_to_str(code)
    assert tf.param_kind_to_str(tf.parse_param_kind("MFCC_0_D_A")) == \
        "MFCC_D_A_0"
    for bad in ("BOGUS", "MFCC_X"):
        with pytest.raises(ValueError):
            tf.parse_param_kind(bad)


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("compress, crc", [(False, False), (True, False),
                                           (True, True)])
def test_files_cross_read_equal(tmp_path, writer, compress, crc):
    """A file written by either package reads identically through both,
    with ranges, extension and derivatives."""
    rng = np.random.default_rng(0)
    mat = (rng.normal(size=(40, 5)) * 7.0).astype(np.float32)
    p = str(tmp_path / "f.fea")
    w = tf if writer == "port" else jf
    w.write_features(p, mat, param_kind=w.parse_param_kind("FBANK"),
                     compress=compress, add_crc=crc)
    assert open(p, "rb").read() == _bytes(
        jf if writer == "port" else tf, tmp_path, mat, compress, crc)
    for path, kw in ((p, {}), (p + "[3,20]", {}),
                     (p + "[0,5]", dict(ext_left=2, ext_right=3)),
                     (p, dict(deriv_order=2)), (p, dict(deriv_order=3)),
                     (p, dict(target_kind=jf.parse_param_kind("FBANK_Z")))):
        got, period, kind = tf.read_features(path, **kw)
        want, jperiod, jkind = jf.read_features(path, **kw)
        assert (period, kind) == (jperiod, jkind)
        np.testing.assert_array_equal(got, want)


def _bytes(pkg, tmp_path, mat, compress, crc):
    q = str(tmp_path / "other.fea")
    pkg.write_features(q, mat, param_kind=pkg.parse_param_kind("FBANK"),
                       compress=compress, add_crc=crc)
    return open(q, "rb").read()


def test_derivatives_regression_formula(tmp_path):
    """deriv_order=2 appends HTK's regression deltas (window 2) with edge
    clamping, as phnrec_tpu computes them."""
    rng = np.random.default_rng(1)
    mat = rng.normal(size=(12, 3)).astype(np.float32)
    p = str(tmp_path / "d.fea")
    tf.write_features(p, mat)
    got, _, kind = tf.read_features(p, deriv_order=2)
    assert got.shape == (12, 9)
    assert kind & tf.PARAMKIND_D and kind & tf.PARAMKIND_A
    np.testing.assert_array_equal(got, jf.read_features(p, deriv_order=2)[0])
    norm = 2 * (1 + 4)
    t = 5
    expect = (1 * (mat[t + 1] - mat[t - 1]) + 2 * (mat[t + 2] - mat[t - 2])
              ) / norm
    np.testing.assert_allclose(got[t, 3:6], expect, atol=1e-5)
    expect0 = (1 * (mat[1] - mat[0]) + 2 * (mat[2] - mat[0])) / norm
    np.testing.assert_allclose(got[0, 3:6], expect0, atol=1e-5)


def test_ceps_norm_files_cross_read(tmp_path):
    rng = np.random.default_rng(2)
    mat = rng.normal(size=(20, 4)).astype(np.float32) + 3.0
    p = str(tmp_path / "z.fea")
    tf.write_features(p, mat, param_kind=tf.parse_param_kind("FBANK"))
    cmn, cvn = str(tmp_path / "cmn"), str(tmp_path / "cvn")
    tf.write_ceps_norm_file(cmn, "mean", tf.parse_param_kind("FBANK"),
                            [1.0, 2.0, 3.0, 4.0])
    jf.write_ceps_norm_file(cvn, "variance", jf.parse_param_kind("FBANK_Z"),
                            [4.0, 4.0, 4.0, 4.0])
    for kw in (dict(cmn_file=cmn), dict(cmn_file=cmn, cvn_file=cvn)):
        got, _, _ = tf.read_features(p, **kw)
        want, _, _ = jf.read_features(p, **kw)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(tf.read_features(p, cmn_file=cmn,
                                                cvn_file=cvn)[0],
                               (mat - np.array([1, 2, 3, 4])) * 0.5,
                               atol=1e-5)
    with pytest.raises(ValueError):
        tf.read_ceps_norm_file(cmn, "mean", tf.parse_param_kind("MFCC"), 4)
