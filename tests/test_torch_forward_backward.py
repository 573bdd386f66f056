"""The phoneme-loop forward-backward (kernel J's plain version on the CPU)
against phnrec_tpu's decoder/forward_backward.py on the same seeded
log-posteriors: log_alpha, log_beta, log_gamma and log_like within measured
tolerances on the tiny and CZ-shaped loops; a float64 brute force; the
occupancy rows; and the ops-level batch against one utterance at a time."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phnrec_tpu.decoder.forward_backward import forward_backward as jfb
from phnrec_tpu.decoder.forward_backward import occupancies as jocc
from phnrec_tpu.decoder.phnloop import PhnLoopSpec as JSpec

from phnrec_tpu_torch.decoder.forward_backward import (forward_backward,
                                                       occupancies)
from phnrec_tpu_torch.decoder.phnloop import PhnLoopSpec
from phnrec_tpu_torch.ops import phnloop_fb

# alpha and beta: chains of float32 logaddexps whose lses sum their exps in
# another order than XLA's; measured max relative error 2.0e-7 (values to
# ~1,500 at CZ x 300 frames)
RTOL_AB = 2e-6
# gamma = alpha + beta - like cancels values of ~|alpha| + |beta|: measured
# max 2.4e-4 absolute where those reach ~3,000, i.e. under 1e-7 of them
REL_GAMMA = 1e-6
# (P, S, T, w_penalty): tiny, CZ-shaped, one state a phoneme
LOOPS = [(5, 3, 20, -2.0), (4, 3, 40, 0.5), (46, 3, 300, -1.5),
         (4, 1, 9, 0.5)]


def _logpost(T, P, S, seed, extra=2):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((T, P * S + extra)) * 2).astype(np.float32)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _brute_loglike(P, S, w, lp, tr=np.log(0.5)):
    """The forward recurrence in float64 numpy."""
    obs = lp[:, : P * S].reshape(-1, P, S).astype(np.float64)
    alpha = np.full((P, S), -np.inf)
    entry = w
    for t in range(obs.shape[0]):
        new = np.empty((P, S))
        for p in range(P):
            for s in range(S):
                acc = alpha[p, s] + tr
                acc = np.logaddexp(acc, alpha[p, s - 1] + tr if s else entry)
                new[p, s] = acc + obs[t, p, s]
        alpha = new
        entry = np.logaddexp.reduce(alpha[:, -1] + tr) + w
    return np.logaddexp.reduce(alpha[:, -1])


@pytest.mark.parametrize("P, S, T, w", LOOPS,
                         ids=[f"P{p}S{s}T{t}" for p, s, t, _ in LOOPS])
def test_matches_jax(P, S, T, w):
    lp = _logpost(T, P, S, seed=P + T)
    want = jfb(JSpec(P, S, w), jnp.asarray(lp))
    got = forward_backward(PhnLoopSpec(P, S, w), torch.tensor(lp))
    for k in ("log_alpha", "log_beta"):
        a, b = np.asarray(getattr(want, k)), getattr(got, k).numpy()
        assert b.shape == (T, P, S) and b.dtype == np.float32
        np.testing.assert_allclose(b, a, rtol=RTOL_AB, atol=1e-5, err_msg=k)
    # the scale of the reachable entries (unreached ones hold ~-FLT_MAX)
    scale = sum(np.abs(v[v > -1e30]).max() for v in (
        np.asarray(want.log_alpha), np.asarray(want.log_beta)))
    np.testing.assert_allclose(got.log_gamma.numpy(),
                               np.asarray(want.log_gamma), rtol=RTOL_AB,
                               atol=REL_GAMMA * scale)
    np.testing.assert_allclose(float(got.log_like), float(want.log_like),
                               rtol=RTOL_AB)


@pytest.mark.parametrize("P, S, T, w", LOOPS[:2],
                         ids=["P5S3T20", "P4S3T40"])
def test_loglike_brute_force(P, S, T, w):
    lp = _logpost(T, P, S, seed=7)
    got = forward_backward(PhnLoopSpec(P, S, w), torch.tensor(lp))
    np.testing.assert_allclose(float(got.log_like),
                               _brute_loglike(P, S, w, lp), rtol=1e-5)
    # alpha_t . beta_t sums to the likelihood at every frame
    la = got.log_alpha.double().numpy().reshape(T, -1)
    lb = got.log_beta.double().numpy().reshape(T, -1)
    per_t = np.logaddexp.reduce(la + lb, axis=1)
    np.testing.assert_allclose(per_t, float(got.log_like), atol=2e-4)


@pytest.mark.parametrize("per_phoneme", [True, False])
def test_occupancies_rows_sum_to_one(per_phoneme):
    spec = PhnLoopSpec(46, 3, -1.5)
    lp = _logpost(120, 46, 3, seed=3)
    g = occupancies(spec, lp, per_phoneme=per_phoneme, device="cpu")
    want = jocc(JSpec(46, 3, -1.5), lp, per_phoneme=per_phoneme)
    assert g.shape == want.shape
    rows = g.reshape(g.shape[0], -1).sum(1)
    # float32 logaddexp chains accumulate ~1e-5 a step, as in JAX's test
    np.testing.assert_allclose(rows, 1.0, atol=1e-3)
    assert np.all(g >= 0)
    np.testing.assert_allclose(g, want, rtol=0, atol=1e-4)


def test_batch_equals_one_at_a_time():
    """Kernel J's wrapper takes a batch [B, T, D]: each row is its own
    utterance, as one call each gives it (within a float32 ulp or so: torch
    vectorizes a batch's reductions differently)."""
    P, S, T = 6, 3, 25
    lps = np.stack([_logpost(T, P, S, seed=s) for s in range(3)])
    args = (P, S, -1.0, float(np.log(0.5)), float(np.log(0.5)))
    a, b, like = phnloop_fb.phnloop_fb(torch.tensor(lps), *args)
    assert phnloop_fb.LAUNCHES == 0          # the CPU ran the plain version
    for i in range(3):
        a1, b1, l1 = phnloop_fb.phnloop_fb_plain(torch.tensor(lps[i:i + 1]),
                                                 *args)
        for x, y in ((a[i], a1[0]), (b[i], b1[0]), (like[i], l1[0])):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-6)
