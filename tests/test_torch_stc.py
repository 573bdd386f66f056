"""The LCRC assembly (two depthwise convs) and the LCRC estimator against
phnrec_tpu at ragged valid lengths.  JAX's conv is an NWC
cross-correlation with output channel g*n_coefs + k; the port's is NCW."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phnrec_tpu.posteriors import estimator as jest
from phnrec_tpu.posteriors import stc as jstc

from phnrec_tpu_torch import synth
from phnrec_tpu_torch.convert import lcrc_from_taps
from phnrec_tpu_torch.posteriors import estimator as test_
from phnrec_tpu_torch.posteriors import stc as tstc


def _windows(seed):
    rng = np.random.default_rng(seed)
    return (rng.random(16).astype(np.float32) + 0.5,
            rng.random(16).astype(np.float32) + 0.5)


@pytest.mark.parametrize("nbanks,n_coefs,add_c0", [(5, 11, True),
                                                   (15, 11, True),
                                                   (4, 6, False)])
def test_assembler_batched_ragged(nbanks, n_coefs, add_c0):
    spec = (nbanks, 31, n_coefs, add_c0)
    wl, wr = _windows(nbanks)
    ja = jstc.LCRCAssembler(jstc.LCRCSpec(*spec), wl, wr)
    ta = tstc.LCRCAssembler(tstc.LCRCSpec(*spec), wl, wr)
    assert np.array_equal(np.asarray(ja.m_left), ta.m_left.numpy())
    assert np.array_equal(np.asarray(ja.m_right), ta.m_right.numpy())
    rng = np.random.default_rng(1)
    B, T = 4, 40
    p = rng.standard_normal((B, T, nbanks)).astype(np.float32)
    n_valid = np.array([40, 23, 1, 16], np.int32)
    want = ja.batched(jnp.asarray(p), jnp.asarray(n_valid))
    got = ta.batched(torch.from_numpy(p), torch.from_numpy(n_valid))
    for w, g in zip(want, got):
        assert g.shape == (B, T, nbanks * n_coefs)
        # 16-tap sums, whose order depends on the conv algorithm: measured
        # 0.0 with this torch build on values of up to 13; 3e-6 is ~2 ulp
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=3e-6)
    # and without n_valid (no tail replication)
    want = ja.batched(jnp.asarray(p))
    got = ta.batched(torch.from_numpy(p))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=3e-6)


def test_lcrc_from_taps():
    wl, wr = _windows(0)
    ja = jstc.LCRCAssembler(jstc.LCRCSpec(15, 31, 11, True), wl, wr)
    ta = lcrc_from_taps(ja.spec, ja.m_left, ja.m_right)
    ref = tstc.LCRCAssembler(tstc.LCRCSpec(15, 31, 11, True), wl, wr)
    assert torch.equal(ta.m_left, ref.m_left)
    assert torch.equal(ta.m_right, ref.m_right)


@pytest.fixture(scope="module")
def pkg(tmp_path_factory):
    return synth.write_lcrc_package(tmp_path_factory.mktemp("stc_pkg"),
                                    "tiny", seed=3)


@pytest.mark.parametrize("fast_exp", [True, False])
def test_estimator_posteriors_batched(pkg, fast_exp):
    je = jest.build_estimator("LCRC", pkg, nbanks=5, fast_exp=fast_exp)
    te = test_.build_estimator("LCRC", pkg, nbanks=5, fast_exp=fast_exp)
    rng = np.random.default_rng(4)
    p = rng.standard_normal((3, 60, 5)).astype(np.float32)
    n_valid = np.array([60, 31, 2], np.int32)
    want = np.asarray(je.posteriors_batched(jnp.asarray(p),
                                            jnp.asarray(n_valid)))
    got = te.posteriors_batched(torch.from_numpy(p),
                                torch.from_numpy(n_valid)).numpy()
    assert got.shape == want.shape == (3, 60, 12)
    # three MLPs and an ln in float32: measured max 1.7e-6 on posteriors
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6)


def test_build_estimator_other_systems_raise(pkg):
    """An unknown system raises; the traps systems are ported and raise
    on an LCRC package's files only where phnrec_tpu raises too
    (tests/test_torch_traps.py holds them to phnrec_tpu)."""
    with pytest.raises(ValueError):
        test_.build_estimator("nope", pkg, nbanks=5)
    for build in (test_.build_estimator, jest.build_estimator):
        # the LCRC package has two band nets, not one a bank
        for system in ("3BT", "1BT"):
            with pytest.raises(FileNotFoundError, match="band2"):
                build(system, pkg, nbanks=5)
        # its merger (24 inputs) is not a multiple of 5 banks
        with pytest.raises(ValueError, match="not divisible"):
            build("1BT_DCT", pkg, nbanks=5)
