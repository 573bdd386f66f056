"""Kernel A''s plain version (the fused MLP in bf16 passes) against
phnrec_tpu's: the Pallas kernel ``_kernel3`` (Precision.HIGH) in interpret
mode, its ``_split_bf16``, and the one-pass product; and the precision
knob that routes MLP.forward between kernels A and A'."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phnrec_tpu.io.weights import MLPParams
from phnrec_tpu.ops.pallas_mlp import _split_bf16, mlp_forward_fused
from phnrec_tpu.posteriors import mlp as jmlp

from phnrec_tpu_torch import precision
from phnrec_tpu_torch.convert import mlp_from_device
from phnrec_tpu_torch.ops import mlp_bf16x3, mlp_fused
from phnrec_tpu_torch.posteriors.mlp import MLP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _params(seed, n_inp, n_hid, n_out):
    """Weights drawn as synth.py draws them (hidden pre-activations within
    about +-20, logits of a few units)."""
    rng = np.random.default_rng(seed)
    w2 = rng.standard_normal((n_out, n_hid)) * (8.0 / np.sqrt(n_hid))
    return MLPParams(
        w1=(rng.standard_normal((n_hid, n_inp))
            * (4.0 / np.sqrt(n_inp))).astype(np.float32),
        b1=(rng.standard_normal(n_hid) * 0.5).astype(np.float32),
        w2=w2.astype(np.float32),
        b2=(-0.5 * w2.sum(1)).astype(np.float32),
        mean=rng.standard_normal(n_inp).astype(np.float32),
        dev=(rng.random(n_inp).astype(np.float32) + 0.5))


def _x(seed, rows, p):
    z = np.random.default_rng(seed).standard_normal((rows, p.n_inp))
    return (z / p.dev + p.mean).astype(np.float32)


@pytest.fixture(autouse=True)
def _mode():
    """Every test starts and ends at the default mode."""
    old = precision.get_mode()
    precision.set_mode("highest")
    yield
    precision.set_mode(old)


def test_split_bf16_matches_jax():
    """hi rounds to nearest even and lo is the float32 residual, rounded
    the same way: bit-equal to JAX's _split_bf16, ties and extremes
    included.  (XLA on the CPU flushes float32 denormals, which the card
    keeps, so the values are normal.)"""
    rng = np.random.default_rng(0)
    ties = (np.arange(0x3000, 0x3000 + 2000, dtype=np.uint32) << 16
            | 0x8000).view(np.float32)
    a = np.concatenate([
        rng.standard_normal(100000).astype(np.float32) * 10.0 ** rng.integers(
            -30, 30, 100000).astype(np.float32),
        # exact ties between two bf16 values, both parities and signs
        ties, -ties,
        np.float32([0.0, -0.0, 1.0, -1.0, 3.4e38, -3.4e38, 1.5e-38])])
    jh, jl = (np.asarray(t).view(np.uint16) for t in _split_bf16(
        jnp.asarray(a)))
    th, tl = (t.view(torch.int16).numpy().view(np.uint16)
              for t in mlp_bf16x3.split_bf16(torch.from_numpy(a)))
    assert np.array_equal(th, jh) and np.array_equal(tl, jl)


def test_split_weights_pads_with_zero():
    p = _params(1, 20, 40, 9)
    m = MLP.from_params(p)
    w1h, w1l, w2h, w2l = mlp_bf16x3.split_weights(m.w1, m.w2)
    assert w1h.shape == (32, 128) and w2h.shape == (128, 16)
    assert w1h.dtype == torch.bfloat16
    for t in (w1h, w1l):
        assert not t[20:].any() and not t[:, 40:].any()
    for t in (w2h, w2l):
        assert not t[40:].any() and not t[:, 9:].any()
    back = w1h[:20, :40].float() + w1l[:20, :40].float()
    assert float((back - m.w1).abs().max()) <= 2 ** -16 * float(
        m.w1.abs().max())
    # the module holds them as buffers, split once
    assert torch.equal(m.w1_hi, w1h) and torch.equal(m.w2_lo, w2l)


@pytest.mark.parametrize("widths", [(55, 32, 12), (165, 1500, 138),
                                    (276, 1500, 138), (500, 130, 300),
                                    (1794, 1500, 138), (2070, 1500, 138)],
                         ids=["tiny", "cz_band", "cz_merger", "wide",
                              "merger_3bt", "merger_1bt"])
@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("apply_softmax", [True, False])
def test_plain_matches_pallas_kernel3(widths, fast, apply_softmax):
    """The plain version with 3 passes against phnrec_tpu's _kernel3 in
    interpret mode (the JAX net padded to 128); "wide" is past the fused
    CUDA kernel's widths (n_inp 480, n_out 256), which the card takes
    through its split path."""
    p = _params(2, *widths)
    net = jmlp.to_device(p, pad=128)
    x = _x(3, 300, p)
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (0, net.w1.shape[0] - p.n_inp)))
    want = np.asarray(mlp_forward_fused(
        xp, net.mean, net.dev, net.w1, net.b1, net.w2, net.b2,
        n_out=net.n_out, fast=fast, apply_softmax=apply_softmax,
        interpret=True, prec=jax.lax.Precision.HIGH))[:, : p.n_out]
    m = mlp_from_device(net)
    got = mlp_bf16x3.mlp_forward_bf16x3_plain(
        torch.from_numpy(x), m.mean, m.dev, m.w1_hi, m.w1_lo, m.b1, m.w2_hi,
        m.w2_lo, m.b2, fast=fast, apply_softmax=apply_softmax,
        passes=3).numpy()
    # the same bf16 products, summed in another order in float32; an h
    # that moves by an ulp can split into another (hi, lo) pair, whose sum
    # keeps ~16 bits, so a product moves by up to ~2^-16 of itself.
    # Measured max 3.9e-6 on probabilities and 2.2e-5 on logits (both on
    # the tiny net, whose logits reach 11), x2.5 margin
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 if apply_softmax else 5e-5)


def test_one_pass_product_matches_bf16_dot():
    """passes=1 is the single bf16 product a_hi @ b_hi with float32 sums,
    JAX's dot of bf16-cast operands with preferred_element_type=float32:
    what the TPU's matrix unit does at Precision.DEFAULT (JAX on the CPU
    ignores Precision.DEFAULT, so this is the arithmetic the TPU runs, not
    what the JAX package computes here)."""
    rng = np.random.default_rng(4)
    a = rng.standard_normal((200, 300)).astype(np.float32)
    b = (rng.standard_normal((300, 140)) * 0.1).astype(np.float32)
    want = np.asarray(jnp.dot(jnp.asarray(a).astype(jnp.bfloat16),
                              jnp.asarray(b).astype(jnp.bfloat16),
                              preferred_element_type=jnp.float32))
    bh, bl = mlp_bf16x3.split_bf16(torch.from_numpy(b))
    got = mlp_bf16x3._dot(torch.from_numpy(a), bh, bl, 1).numpy()
    # exact products, float32 sums in another order; measured max 4.8e-7
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-6)
    # and 3 passes are within the bf16x3 truncation of the float32 product
    got3 = mlp_bf16x3._dot(torch.from_numpy(a), bh, bl, 3).numpy()
    np.testing.assert_allclose(got3, a @ b, rtol=0, atol=2e-4)


def test_passes_checked():
    m = MLP.from_params(_params(5, 10, 16, 6))
    x = torch.zeros(3, 10)
    with pytest.raises(ValueError, match="passes"):
        mlp_bf16x3.mlp_forward_bf16x3(
            x, m.mean, m.dev, m.w1_hi, m.w1_lo, m.b1, m.w2_hi, m.w2_lo, m.b2,
            passes=2)


def _mode_in_subprocess(value):
    env = dict(os.environ, PHNREC_TPU_PRECISION=value)
    return subprocess.run(
        [sys.executable, "-c", "from phnrec_tpu_torch import precision; "
         "print(precision.get_mode())"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120).stdout.strip()


def test_precision_env_and_setters():
    assert [_mode_in_subprocess(v) for v in ("HIGH", "default", "bogus")] \
        == ["high", "default", "highest"]
    assert precision.get_mode() == "highest" and precision.mlp_passes() == 0
    precision.set_mode("high")
    assert precision.get_mode() == "high" and precision.mlp_passes() == 3
    precision.set_mode("default")
    assert precision.mlp_passes() == 1
    with pytest.raises(ValueError, match="precision mode"):
        precision.set_mode("fast")
    assert precision.get_mode() == "default"


@pytest.mark.parametrize("mode,passes", [("highest", 0), ("high", 3),
                                         ("default", 1)])
@pytest.mark.parametrize("plain", [False, True])
def test_forward_routes_by_mode(monkeypatch, mode, passes, plain):
    """MLP.forward reads the mode at each call: kernel A at highest, A'
    with 3 or 1 passes at high and default, the selected kernel's plain
    version with plain=True; the result is that function's."""
    calls = []

    def spy(name, fn):
        def f(*a, **kw):
            calls.append((name, kw.get("passes")))
            return fn(*a, **kw)
        return f

    for mod, name in ((mlp_fused, "mlp_forward"),
                      (mlp_fused, "mlp_forward_plain"),
                      (mlp_bf16x3, "mlp_forward_bf16x3"),
                      (mlp_bf16x3, "mlp_forward_bf16x3_plain")):
        monkeypatch.setattr(mod, name, spy(name, getattr(mod, name)))
    p = _params(6, 30, 64, 12)
    m = MLP.from_params(p)
    x = torch.from_numpy(_x(7, 9, p)).reshape(3, 3, 30)
    precision.set_mode(mode)
    out = m(x, plain=plain)
    name = "mlp_forward" if passes == 0 else "mlp_forward_bf16x3"
    # on CPU tensors the wrapper itself takes its plain version
    want_calls = [(name + "_plain", passes or None)]
    if not plain:
        want_calls.insert(0, (name, passes or None))
    assert calls == want_calls
    assert out.shape == (3, 3, 12)
    if passes:
        want = mlp_bf16x3.mlp_forward_bf16x3_plain(
            x.reshape(9, 30), m.mean, m.dev, m.w1_hi, m.w1_lo, m.b1,
            m.w2_hi, m.w2_lo, m.b2, passes=passes)
    else:
        want = mlp_fused.mlp_forward_plain(x.reshape(9, 30), m.mean, m.dev,
                                           m.w1, m.b1, m.w2, m.b2)
    assert torch.equal(out.reshape(9, 12), want)


def test_modes_agree_within_their_precision():
    """At the CZ band's widths the three modes give the same posteriors
    within what their passes keep (~16 bits of each operand with 3
    passes, ~8 with one): 3 passes within 5e-5 of float32, one pass
    within 3e-2 (measured 2.0e-5 and 1.2e-2)."""
    p = _params(8, 165, 1500, 138)
    m = MLP.from_params(p)
    x = torch.from_numpy(_x(9, 200, p))
    out = {}
    for mode in ("highest", "high", "default"):
        precision.set_mode(mode)
        out[mode] = m(x)
    assert float((out["high"] - out["highest"]).abs().max()) <= 5e-5
    assert float((out["default"] - out["highest"]).abs().max()) <= 3e-2


@pytest.mark.parametrize("shape,kws", [("cz", False), ("en", False),
                                       ("tiny", False), ("en", True),
                                       ("tiny", True)],
                         ids=["cz", "en", "tiny", "kws_en", "kws_tiny"])
def test_synthetic_package_widths_pass_the_shared_check(tmp_path, shape,
                                                        kws):
    """Kernels A and A' take the same widths on their fused kernels
    (mlp_fused.fused_takes, which both wrappers ask; wider nets take the
    split paths): every net of every synthetic package takes the fused
    kernels."""
    from phnrec_tpu_torch import synth
    from phnrec_tpu_torch.pipeline import SpeechRec
    write = synth.write_kws_package if kws else synth.write_lcrc_package
    est = SpeechRec(write(str(tmp_path / shape), shape, seed=0),
                    device="cpu").estimator
    nets = (*est.band, est.merger)
    assert len(nets) == 3
    for net in nets:
        assert mlp_fused.fused_takes(net.n_inp, net.n_out)
