"""Kernel A's plain version (fexp, the fused MLP forward) against
phnrec_tpu's: the jnp chain of posteriors/mlp.py and the Pallas kernel in
interpret mode, as tests/test_pallas_mlp.py runs it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phnrec_tpu.io.weights import MLPParams
from phnrec_tpu.ops.pallas_mlp import mlp_forward_fused
from phnrec_tpu.posteriors import fexp as jfexp
from phnrec_tpu.posteriors import mlp as jmlp

from phnrec_tpu_torch.convert import mlp_from_device, mlp_from_params
from phnrec_tpu_torch.posteriors import fexp as tfexp
from phnrec_tpu_torch.posteriors.mlp import MLP


def _params(seed=0, n_inp=165, n_hid=200, n_out=138, scale=0.3):
    rng = np.random.default_rng(seed)
    return MLPParams(
        w1=rng.standard_normal((n_hid, n_inp)).astype(np.float32) * scale,
        b1=rng.standard_normal(n_hid).astype(np.float32) * 0.1,
        w2=rng.standard_normal((n_out, n_hid)).astype(np.float32) * scale,
        b2=rng.standard_normal(n_out).astype(np.float32) * 0.1,
        mean=rng.standard_normal(n_inp).astype(np.float32),
        dev=(rng.random(n_inp).astype(np.float32) + 0.5))


def _x(seed, rows, n_inp):
    return np.random.default_rng(seed).standard_normal(
        (rows, n_inp)).astype(np.float32)


@pytest.mark.parametrize("scale", [1.0, 30.0, 200.0, 3000.0])
def test_fexp_matches_jax(scale):
    rng = np.random.default_rng(int(scale))
    y = (rng.standard_normal(50000) * scale).astype(np.float32)
    y[:6] = [0.0, 88.0, 89.0, -87.0, -88.0, -1e4]
    want = np.asarray(jfexp.fexp(jnp.asarray(y)))
    got = tfexp.fexp(torch.from_numpy(y)).numpy()
    # exactly 0 where XLA flushes (2^e, e <= -126) and inf where it overflows
    assert np.array_equal(got == 0, want == 0)
    assert np.array_equal(np.isinf(got), np.isinf(want))
    ok = np.isfinite(want) & (want != 0)
    # XLA's CPU exp2 of an integer is approximate (measured up to 4.1e-6
    # relative for |e| >= 13); the port builds 2^e exactly
    np.testing.assert_allclose(got[ok], want[ok], rtol=5e-6, atol=0)


def test_fexp_exact_definition():
    """The port computes phnrec_tpu's definition exactly: a float32 product
    truncated with saturation, a wrapping int32 add, and an exact 2^e (here
    in float64 and int64 numpy)."""
    y = np.concatenate([np.linspace(-100, 100, 40001, dtype=np.float32),
                        np.float32([3e3, -3e3, 1e9, -1e9])])
    a = (np.float32(jfexp.FEXP_A) * y).astype(np.float64)
    i = np.clip(np.trunc(a), -2 ** 31, 2 ** 31 - 1).astype(np.int64)
    t = (i + jfexp.FEXP_K + 2 ** 31) % 2 ** 32 - 2 ** 31
    e = (t >> 20) - 1023
    with np.errstate(over="ignore"):
        want = np.ldexp(1.0 + (t & 0xFFFFF) / 2.0 ** 20, e).astype(np.float32)
    want[e <= -126] = 0.0
    got = tfexp.fexp(torch.from_numpy(y)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("apply_softmax", [True, False])
def test_forward_matches_jnp_chain(fast, apply_softmax):
    p = _params()
    x = _x(1, 37, p.n_inp)
    want = np.asarray(jmlp.forward(jmlp.to_device(p), jnp.asarray(x),
                                   fast=fast, apply_softmax=apply_softmax,
                                   use_pallas=False))
    got = MLP.from_params(p)(torch.from_numpy(x), fast=fast,
                             apply_softmax=apply_softmax).numpy()
    # float32 GEMMs summed in another order; fexp steps by 2^-20 relative
    # and JAX's exp2 is approximate (above): measured max 2.4e-7 on
    # probabilities and 1.9e-6 on logits of up to 9.4
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-6 if apply_softmax else 2e-5)


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("apply_softmax", [True, False])
def test_forward_matches_pallas_interpret(fast, apply_softmax):
    p = _params(seed=3)
    net = jmlp.to_device(p, pad=128)
    x = _x(4, 37, p.n_inp)
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (0, net.w1.shape[0] - p.n_inp)))
    want = np.asarray(mlp_forward_fused(
        xp, net.mean, net.dev, net.w1, net.b1, net.w2, net.b2,
        n_out=net.n_out, fast=fast, apply_softmax=apply_softmax,
        interpret=True, prec=jax.lax.Precision.HIGHEST))[:, : p.n_out]
    got = mlp_from_device(net)(torch.from_numpy(x), fast=fast,
                               apply_softmax=apply_softmax).numpy()
    # as above; measured max 8.9e-8 on probabilities, 4.8e-7 on logits
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-6 if apply_softmax else 2e-5)


@pytest.mark.parametrize("rows", [1, 37, 130])
@pytest.mark.parametrize("n_inp, n_hid, n_out", [(165, 70, 138),
                                                 (253, 130, 120)])
@pytest.mark.parametrize("fast, apply_softmax", [(True, True),
                                                 (False, False)])
def test_forward_matches_pallas_interpret_ragged(rows, n_inp, n_hid, n_out,
                                                 fast, apply_softmax):
    """Shapes that fill no tile of the CUDA kernel: rows that are a multiple
    of neither row tile, n_inp of no multiple of 4, n_hid of no multiple of
    its slab or chunk, n_out of no multiple of 32."""
    p = _params(seed=rows + n_inp, n_inp=n_inp, n_hid=n_hid, n_out=n_out)
    net = jmlp.to_device(p, pad=128)
    x = _x(rows, rows, n_inp)
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (0, net.w1.shape[0] - n_inp)))
    want = np.asarray(mlp_forward_fused(
        xp, net.mean, net.dev, net.w1, net.b1, net.w2, net.b2,
        n_out=net.n_out, fast=fast, apply_softmax=apply_softmax,
        interpret=True, prec=jax.lax.Precision.HIGHEST))[:, :n_out]
    got = mlp_from_device(net)(torch.from_numpy(x), fast=fast,
                               apply_softmax=apply_softmax).numpy()
    assert got.shape == (rows, n_out)
    # the tolerances of test_forward_matches_pallas_interpret
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-6 if apply_softmax else 2e-5)


def test_convert_weights():
    p = _params(seed=5, n_inp=55, n_hid=32, n_out=12)
    ref = MLP.from_params(p)
    for m in (mlp_from_device(jmlp.to_device(p)),
              mlp_from_device(jmlp.to_device(p, pad=128)),
              mlp_from_params(p)):
        assert (m.n_inp, m.n_hid, m.n_out) == (55, 32, 12)
        for name, buf in ref.named_buffers():
            assert torch.equal(getattr(m, name), buf), name


def test_forward_leading_dims():
    """[B, T, n_inp] inputs (the estimator's) flatten to rows and back."""
    p = _params(seed=6, n_inp=20, n_hid=16, n_out=9)
    x = _x(7, 2 * 5, 20)
    m = MLP.from_params(p)
    flat = m(torch.from_numpy(x))
    lead = m(torch.from_numpy(x).reshape(2, 5, 20))
    assert lead.shape == (2, 5, 9)
    assert torch.equal(lead.reshape(10, 9), flat)


@pytest.mark.parametrize("n_inp, n_hid, n_out", [(500, 130, 300),
                                                 (500, 70, 138),
                                                 (165, 70, 300),
                                                 (1794, 1500, 138),
                                                 (2070, 1500, 138)])
@pytest.mark.parametrize("fast, apply_softmax", [(True, True),
                                                 (False, False)])
def test_forward_wide_matches_jax(n_inp, n_hid, n_out, fast, apply_softmax):
    """Past the fused CUDA kernel's widths (n_inp 480, n_out 256), which
    the card takes through its split path: the plain version against the
    jnp chain and the Pallas kernel in interpret mode."""
    p = _params(seed=n_inp + n_out, n_inp=n_inp, n_hid=n_hid, n_out=n_out)
    x = _x(5, 37, n_inp)
    chain = np.asarray(jmlp.forward(jmlp.to_device(p), jnp.asarray(x),
                                    fast=fast, apply_softmax=apply_softmax,
                                    use_pallas=False))
    net = jmlp.to_device(p, pad=128)
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (0, net.w1.shape[0] - n_inp)))
    pallas = np.asarray(mlp_forward_fused(
        xp, net.mean, net.dev, net.w1, net.b1, net.w2, net.b2,
        n_out=net.n_out, fast=fast, apply_softmax=apply_softmax,
        interpret=True, prec=jax.lax.Precision.HIGHEST))[:, :n_out]
    got = mlp_from_device(net)(torch.from_numpy(x), fast=fast,
                               apply_softmax=apply_softmax).numpy()
    assert got.shape == (37, n_out)
    # the tolerances of test_forward_matches_jnp_chain; at the mergers'
    # widths (n_inp 1,794 and 2,070) the logits reach 29 and the two JAX
    # references differ from each other by up to 5.9e-6 on probabilities
    # and 2.7e-5 on logits (the port from them by up to 6.0e-6 / 3.0e-5),
    # so those cases alone take x2.5 that
    merger = n_inp > 1000
    atol = ((1.5e-5 if merger else 2e-6) if apply_softmax
            else (7.5e-5 if merger else 2e-5))
    for want in (chain, pallas):
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
