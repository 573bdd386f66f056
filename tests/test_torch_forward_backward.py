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


def _lae(a, b):
    """jnp.logaddexp in float32, as kernel J's lae."""
    with np.errstate(over="ignore", invalid="ignore"):
        out = np.maximum(a, b) + np.log1p(np.exp(-np.abs(a - b)))
    return np.where(np.isinf(a) & (a == b), a, out).astype(np.float32)


def _group_lse(x, mask, epl):
    """Kernel J's group lse over the states of ``mask`` (thread i holds
    states i * epl ..): each warp's max m_w (-inf where it has none), its
    lanes' exps of x - m_w (0 for m_w where not finite) summed in slot
    order, the xor butterfly over its 32 lanes; then M the largest m_w (0
    where not finite) and sum_w s_w exp(m_w - M) in warp order."""
    nw = x.size // (32 * epl)
    xs, ms = x.reshape(nw, 32, epl), mask.reshape(nw, 32, epl)
    lanes = np.arange(32)
    pm, psum = [], []
    for w in range(nw):
        m = xs[w][ms[w]].max() if ms[w].any() else np.float32(-np.inf)
        mm = np.float32(m if np.isfinite(m) else 0.0)
        with np.errstate(over="ignore"):   # unmasked states may lie far above
            e = np.where(ms[w], np.exp(xs[w] - mm), 0).astype(np.float32)
        s = np.zeros(32, np.float32)
        for j in range(epl):
            s = s + e[:, j]
        for o in (16, 8, 4, 2, 1):
            s = s + s[lanes ^ o]
        pm.append(np.float32(m))
        psum.append(s[0])
    M = max(pm)
    M = np.float32(M if np.isfinite(M) else 0.0)
    tot = np.float32(0)
    for m, s in zip(pm, psum):
        if m > -np.inf:
            mm = np.float32(m if np.isfinite(m) else 0.0)
            tot = np.float32(tot + s * np.float32(np.exp(mm - M)))
    return np.float32(np.log(tot) + M)


def _group_model(P, S, w, lp, tr=np.float32(np.log(0.5))):
    """Kernel J's group instance in float32 numpy: log_alpha, log_beta
    [T, P, S] and log_like."""
    PS, T = P * S, lp.shape[0]
    epl, nw = phnloop_fb.group_shape(PS)
    n = 32 * epl * nw
    neg = np.float32(phnloop_fb.NEG)
    k = np.arange(n)
    live, first, last = k < PS, (k < PS) & (k % S == 0), \
        (k < PS) & (k % S == S - 1)
    obs = np.zeros((T, n), np.float32)
    obs[:, :PS] = lp[:, :PS]
    w = np.float32(w)
    alphas, betas = np.empty((T, PS), np.float32), np.empty((T, PS),
                                                            np.float32)
    a, entry = np.full(n, neg, np.float32), w
    for t in range(T):
        prev = np.concatenate([[neg], a[:-1]]).astype(np.float32)
        adv = np.where(first, neg, prev + tr)
        inc = np.where(first, entry, neg)
        a = np.where(live, _lae(_lae(a + tr, adv), inc) + obs[t], neg)
        a = a.astype(np.float32)
        alphas[t] = a[:PS]
        entry = np.float32(_group_lse((a + tr).astype(np.float32), last, epl)
                           + w)
    like = _group_lse(a, last, epl)
    b = np.where(last, np.float32(0), neg).astype(np.float32)
    for t in range(T - 1, -1, -1):
        betas[t] = b[:PS]
        bo = np.where(live, b + obs[t], neg).astype(np.float32)
        re = np.float32(_group_lse(bo, first, epl) + w)
        nxt = np.concatenate([bo[1:], [neg]]).astype(np.float32)
        adv = np.where(last, neg, nxt + tr)
        ext = np.where(last, np.float32(tr + re), neg)
        b = np.where(live, _lae(_lae(bo + tr, adv), ext), neg)
        b = b.astype(np.float32)
    return (alphas.reshape(T, P, S), betas.reshape(T, P, S),
            np.float32(like))


@pytest.mark.parametrize("P, S, T, w", [(46, 3, 500, -1.5), (4, 3, 40, 0.5),
                                        (33, 1, 30, -1.0),
                                        (200, 5, 20, -0.5)],
                         ids=["P46S3T500", "P4S3T40", "P33S1T30",
                              "P200S5T20"])
def test_group_summation_order_matches_jax(P, S, T, w):
    """Kernel J's group instance sums each lse's exps per lane, by a
    butterfly per warp, then across warps: modelled in numpy, within the
    card's tolerance (trainfb_variants.TOL, relative to max(|x|, 1)) of
    phnrec_tpu."""
    from phnrec_tpu_torch.devtools.trainfb_variants import TOL, rel_err
    lp = _logpost(T, P, S, seed=P * T)
    want = jfb(JSpec(P, S, w), jnp.asarray(lp))
    got = _group_model(P, S, w, lp)
    for g, k in zip(got, ("log_alpha", "log_beta", "log_like")):
        err = rel_err(torch.from_numpy(np.array(g)),
                      torch.from_numpy(np.array(getattr(want, k))))
        assert err <= TOL, (k, err)


def test_instance_plan_matches_the_source():
    """Kernel J's instance plan (ops/phnloop_fb.py) and the group
    instance's constants and instances in csrc/trainfb.cu agree."""
    import re

    from phnrec_tpu_torch.ops import _build
    src = open(_build.CSRC / "trainfb.cu").read()
    assert (f"constexpr int J_GROUP_MAX = {phnloop_fb.GROUP_MAX_STATES};"
            in src)
    assert f"constexpr int J_WARPS = {phnloop_fb.GROUP_WARPS};" in src
    epls = re.search(r"constexpr int J_EPLS\[\] = \{([^}]*)\};", src)
    top = phnloop_fb.GROUP_EPLS[-1]
    assert tuple(int(v) for v in epls.group(1).split(",")) == \
        phnloop_fb.GROUP_EPLS
    cases = {int(c) for c in re.findall(
        r"case (\d+): return phnloop_fb_group_kernel<\1>;", src)}
    assert cases | {top} == set(phnloop_fb.GROUP_EPLS)
    assert f"default: return phnloop_fb_group_kernel<{top}>;" in src
    assert phnloop_fb.GROUP_MAX_STATES == \
        phnloop_fb.GROUP_WARPS * 32 * top
    for P, S, inst, shape in ((4, 3, "group", (1, 1)),
                              (46, 3, "group", (2, 3)),
                              (16, 2, "group", (1, 1)),
                              (256, 4, "group", (8, 4)),
                              (205, 5, "block", None),
                              (2100, 3, "block", None)):
        assert phnloop_fb.plan_instance(P, S) == inst
        if shape:
            assert phnloop_fb.group_shape(P * S) == shape
