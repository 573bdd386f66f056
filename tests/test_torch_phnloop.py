"""Kernels C and D's plain versions (the Viterbi scan and the device
backtrack) against phnrec_tpu on the same log-posteriors: History and
Segments bit-equal, labels equal to the host replay."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phnrec_tpu.decoder import phnloop as jpl

from phnrec_tpu_torch.decoder import phnloop as tpl


def _random_case(seed, B=5, T=64, P=7, S=3):
    """The random cases of tests/test_device_backtrack.py."""
    rng = np.random.default_rng(seed)
    lp = np.log(rng.dirichlet(np.ones(P * S), size=(B, T))).astype(np.float32)
    n_frames = rng.integers(S, T + 1, size=B).astype(np.int32)
    n_frames[0] = T  # always one full-length row
    return P, S, lp, n_frames


def _specs(P, S, w_penalty=-2.5):
    return (jpl.PhnLoopSpec(n_phonemes=P, n_states=S, w_penalty=w_penalty),
            tpl.PhnLoopSpec(n_phonemes=P, n_states=S, w_penalty=w_penalty))


def _assert_hist_equal(got, want):
    for g, w, dt in zip(got, want, (np.int8, np.int32, np.float32)):
        g = g.numpy()
        assert g.dtype == dt
        assert np.array_equal(g, np.asarray(w))


CASES = [dict(seed=s) for s in range(4)] + [
    dict(seed=7, P=46, S=3, T=50, B=3),       # the CZ loop
    dict(seed=8, P=2, S=1, T=33, B=3),
    dict(seed=9, P=5, S=5, T=40, B=2)]


@pytest.mark.parametrize("case", CASES)
def test_viterbi_history_bit_equal(case):
    P, S, lp, n_frames = _random_case(**case)
    jspec, tspec = _specs(P, S)
    want = jpl.viterbi_scan_batch(jspec, jnp.asarray(lp))
    got = tpl.viterbi_scan_batch(tspec, torch.from_numpy(lp))
    _assert_hist_equal(got, want)


def test_viterbi_carry_through_blocks_with_t0():
    P, S, lp, _ = _random_case(11, B=4, T=70)
    jspec, tspec = _specs(P, S, w_penalty=-4.6875)
    jc = jpl.init_carry(jspec, 4)
    tc = tpl.init_carry(tspec, 4)
    for a, b in zip(tc, jc):
        assert np.array_equal(a.numpy(), np.asarray(b))
    t_hists = []
    for lo, hi in ((0, 25), (25, 26), (26, 70)):
        jc, jh = jpl.viterbi_block(jspec, jc, jnp.asarray(lp[:, lo:hi]),
                                   jnp.int32(lo))
        tc, th = tpl.viterbi_block(tspec, tc, torch.from_numpy(lp[:, lo:hi]),
                                   lo)
        _assert_hist_equal(th, jh)
        for a, b in zip(tc, jc):
            assert np.array_equal(a.numpy(), np.asarray(b))
        t_hists.append(th)
    # the blocks equal one whole-utterance scan
    whole = tpl.viterbi_scan_batch(tspec, torch.from_numpy(lp))
    for w, parts in zip(whole, zip(*t_hists)):
        assert torch.equal(w, torch.cat(parts))


@pytest.mark.parametrize("case", CASES)
def test_backtrack_segments_equal(case):
    P, S, lp, n_frames = _random_case(**case)
    jspec, tspec = _specs(P, S)
    hist = jpl.viterbi_scan_batch(jspec, jnp.asarray(lp))
    want = jpl.backtrack_device(jspec, hist, jnp.asarray(n_frames))
    got = tpl.backtrack_device(
        tspec, tpl.History(*(torch.tensor(np.asarray(a)) for a in hist)),
        torch.from_numpy(n_frames))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        assert np.array_equal(g.numpy(), w)


def _synthetic_history(seed, B, T, hop=(3, 22), one_segment=False):
    """A numpy History [T, B]: frame t enters at t + 1 - L (clipped at 0),
    L drawn from [hop[0], hop[1]); with ``one_segment`` every other column
    enters at 0.  -> (max_phn, ent, alpha, n_frames), n_frames in [1, T]
    with T in column 0."""
    rng = np.random.default_rng(seed)
    L = rng.integers(hop[0], hop[1], (T, B))
    ent = np.maximum(np.arange(T)[:, None] + 1 - L, 0).astype(np.int32)
    if one_segment:
        ent[:, ::2] = 0
    max_phn = rng.integers(0, 46, (T, B)).astype(np.int8)
    alpha = rng.normal(-50, 30, (T, B)).astype(np.float32)
    n_frames = rng.integers(1, T + 1, B).astype(np.int32)
    n_frames[0] = T
    return max_phn, ent, alpha, n_frames


# kernel D's walk over numpy-made Histories: a serving run's length,
# int32 starts (T >= 2^15), hops of exactly S frames (count = T // S on
# the whole row) and rows of one segment
SYNTHETIC = {
    "long_T6146_B3": dict(seed=21, B=3, T=6146),
    "i32_T33000_B2": dict(seed=22, B=2, T=33000),
    "hops_exactly_S3": dict(seed=23, B=4, T=384, hop=(3, 4)),
    "hops_exactly_S4": dict(seed=24, B=3, T=512, hop=(4, 5)),
    "one_segment": dict(seed=25, B=4, T=300, one_segment=True),
}


@pytest.mark.parametrize("case", SYNTHETIC)
def test_backtrack_synthetic_history_equal(case):
    """The port's D (its plain version here) against phnrec_tpu's
    backtrack_device: every field equal, the same dtype."""
    kw = SYNTHETIC[case]
    S = kw.get("hop", (3,))[0]
    jspec, tspec = _specs(46, S)
    max_phn, ent, alpha, n_frames = _synthetic_history(**kw)
    want = jpl.backtrack_device(
        jspec, jpl.History(jnp.asarray(max_phn), jnp.asarray(ent),
                           jnp.asarray(alpha)), jnp.asarray(n_frames))
    got = tpl.backtrack_device(
        tspec, tpl.History(*(torch.from_numpy(a)
                             for a in (max_phn, ent, alpha))),
        torch.from_numpy(n_frames))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        assert np.array_equal(g.numpy(), w)
    T = kw["T"]
    assert got.start.dtype == (torch.int32 if T >= 2 ** 15 else torch.int16)
    if "hop" in kw:
        assert int(got.count[0]) == -(-T // S)
    if kw.get("one_segment"):
        assert (got.count[::2] == 1).all()


@pytest.mark.parametrize("case", CASES)
def test_labels_equal_host_replay(case):
    P, S, lp, n_frames = _random_case(**case)
    jspec, tspec = _specs(P, S)
    names = [f"p{i}" for i in range(P)]
    want = jpl.backtrack_batch(
        jpl.viterbi_scan_batch(jspec, jnp.asarray(lp)), n_frames, names)
    hist = tpl.viterbi_scan_batch(tspec, torch.from_numpy(lp))
    segs = tpl.fetch_segments(tpl.backtrack_device(
        tspec, hist, torch.from_numpy(n_frames)))
    got = tpl.labels_from_segments(segs, n_frames, names)
    replay = tpl.backtrack_batch(hist, n_frames, names)
    assert len(got) == len(want) == len(replay)
    for g, w, r in zip(got, want, replay):
        key = [(l.start_frames, l.end_frames, l.name) for l in w]
        assert [(l.start_frames, l.end_frames, l.name) for l in g] == key
        assert [(l.start_frames, l.end_frames, l.name) for l in r] == key
        # scores: float64 deltas of the same float32 alphas here, float32
        # deltas in phnrec_tpu's native replay: measured max 9.5e-7
        # (1 ulp of scores of ~40)
        np.testing.assert_allclose([l.score for l in g],
                                   [l.score for l in w], rtol=0, atol=1e-5)
        assert [l.score for l in g] == [l.score for l in r]


def test_segment_capacity_and_limits():
    P, S, lp, n_frames = _random_case(99, B=3, T=33, P=2, S=3)
    _, tspec = _specs(P, S)
    hist = tpl.viterbi_scan_batch(tspec, torch.from_numpy(lp))
    segs = tpl.backtrack_device(tspec, hist, torch.from_numpy(n_frames))
    assert int(segs.count.max()) <= tpl.max_segments(tspec, 33)
    # past each row's count, every slot is exactly 0
    for b, k in enumerate(segs.count.tolist()):
        assert not segs.phn[b, k:].any() and not segs.start[b, k:].any()
        assert not segs.alpha_end[b, k:].any()
    # a row whose count reaches Smax was truncated: the fetch refuses it
    full = tpl.Segments(torch.full_like(segs.count, segs.phn.shape[1]),
                        *segs[1:])
    with pytest.raises(AssertionError, match="capacity"):
        tpl.fetch_segments(full)
    big = tpl.History(torch.zeros((1 << 20, 1), dtype=torch.int8),
                      torch.zeros((1 << 20, 1), dtype=torch.int32),
                      torch.zeros((1 << 20, 1), dtype=torch.float32))
    with pytest.raises(ValueError, match="20 bits"):
        tpl.backtrack_device(tspec, big, torch.ones(1, dtype=torch.int32))


def test_fetch_segments_caps_slots():
    P, S, lp, n_frames = _random_case(5, B=2, T=64)
    _, tspec = _specs(P, S)
    segs = tpl.backtrack_device(
        tspec, tpl.viterbi_scan_batch(tspec, torch.from_numpy(lp)),
        torch.from_numpy(n_frames))
    small = tpl.fetch_segments(segs, cap=int(segs.count.max()))
    full = tpl.fetch_segments(segs, cap=1000)
    assert small.phn.shape[1] == int(segs.count.max())
    assert full.phn.shape[1] == segs.phn.shape[1]
    names = [f"p{i}" for i in range(P)]
    a = tpl.labels_from_segments(small, n_frames, names)
    b = tpl.labels_from_segments(full, n_frames, names)
    assert a == b
    # a cap below the longest row fetches every slot
    assert tpl.fetch_segments(segs, cap=1).phn.shape[1] == segs.phn.shape[1]


def _exit_ties(spec, carry, lp):
    """Frames whose loop maximum several phonemes reach, and frames whose
    tied maxima hold both -0.0 and +0.0, over the plain scan."""
    from phnrec_tpu_torch.ops.phnloop_viterbi import _setup, _step
    alphas, ent = carry
    obs, _, scalars = _setup(lp, spec.n_phonemes, spec.n_states,
                             spec.w_penalty, spec.log_tr_curr,
                             spec.log_tr_next)
    tied = signed = 0
    for t in range(obs.shape[0]):
        alphas, ent, rec = _step(alphas, ent, obs[t], t + 1, *scalars)
        exit_a = alphas[:, -1, :]
        at_max = exit_a == rec[2][None, :]
        tied += int((at_max.sum(0) > 1).sum())
        neg = (at_max & torch.signbit(exit_a)).any(0)
        pos = (at_max & ~torch.signbit(exit_a)).any(0)
        signed += int((neg & pos).sum())
    return tied, signed


# small-integer observations: "ints" 0 (as -0.0), -1, -2, -3 with the CZ
# loop's constants; "zeros" +0.0 or -0.0 at 70% with w_penalty -0.0,
# tr_curr +0.0 and tr_next -0.0, so maxima tie at -0.0 against +0.0 (the
# cases chip_smoke.py holds kernel C to)
TIE_CASES = [dict(P=P, S=S, ties=ties) for P in (7, 33, 128)
             for S in (1, 5) for ties in ("ints", "zeros")]


@pytest.mark.parametrize("case", TIE_CASES)
def test_viterbi_tie_heavy_bit_equal(case):
    """Kernel C's plain version against phnrec_tpu's viterbi_block on
    tie-heavy small-integer observations with -0.0: many frames' loop
    maxima are reached by several phonemes (in the one-state "zeros"
    cases some at -0.0 and +0.0 at once); the same winners, and carry and
    History equal as floats, also over two blocks chained with t0.  (The
    port records the lowest phoneme's own value, as the reference's
    `tok > max` loop keeps its token; phnrec_tpu records jnp.max, which
    may be +0.0 where the winner holds -0.0: equal as floats, so the
    comparison is by value.)"""
    from phnrec_tpu_torch.devtools.scan_variants import viterbi_case
    P, S = case["P"], case["S"]
    tspec, lp, _, _ = viterbi_case("cpu", P, S, 3, 30, P * S + 1,
                                   seed=P + S, ties=case["ties"])
    jspec = jpl.PhnLoopSpec(*tspec)
    tc, jc = tpl.init_carry(tspec, 3), jpl.init_carry(jspec, 3)
    tied, signed = _exit_ties(tspec, tc, lp)
    assert tied >= 5
    if case["ties"] == "zeros" and S == 1:
        assert signed > 0
    for lo, hi in ((0, 13), (13, 30)):
        x = lp[:, lo:hi].contiguous()
        jc, jh = jpl.viterbi_block(jspec, jc, jnp.asarray(x.numpy()),
                                   jnp.int32(lo + 5))
        tc, th = tpl.viterbi_block(tspec, tc, x, lo + 5)
        _assert_hist_equal(th, jh)
        for a, b in zip(tc, jc):
            assert np.array_equal(a.numpy(), np.asarray(b))


# past kernel C's templates: S 6 and 7 (its run-time-S kernel) and rows
# wider than one ring stage (4,073 columns), tie-heavy "ints" observations
WIDE_CASES = [dict(P=9, S=6, D=54), dict(P=20, S=7, D=141),
              dict(P=46, S=3, D=4100), dict(P=5, S=6, D=4200)]


@pytest.mark.parametrize("case", WIDE_CASES,
                         ids=[f"P{c['P']}_S{c['S']}_D{c['D']}"
                              for c in WIDE_CASES])
def test_viterbi_wide_bit_equal(case):
    """Kernels C and C''s plain versions against phnrec_tpu's
    viterbi_block and viterbi_block_ragged at the widths the card takes
    through the run-time-S kernel: carry and (valid) History equal, C over
    two blocks chained with t0, C' with ragged rows."""
    from phnrec_tpu_torch.devtools.scan_variants import viterbi_case
    P, S, D = case["P"], case["S"], case["D"]
    tspec, lp, t0, nv = viterbi_case("cpu", P, S, 4, 24, D, seed=P + S + D,
                                     ties="ints")
    jspec = jpl.PhnLoopSpec(*tspec)
    tc, jc = tpl.init_carry(tspec, 4), jpl.init_carry(jspec, 4)
    for lo, hi in ((0, 11), (11, 24)):
        x = lp[:, lo:hi].contiguous()
        jc, jh = jpl.viterbi_block(jspec, jc, jnp.asarray(x.numpy()),
                                   jnp.int32(lo + 2))
        tc, th = tpl.viterbi_block(tspec, tc, x, lo + 2)
        _assert_hist_equal(th, jh)
        for a, b in zip(tc, jc):
            assert np.array_equal(a.numpy(), np.asarray(b))
    tc, jc = tpl.init_carry(tspec, 4), jpl.init_carry(jspec, 4)
    jc, jh = jpl.viterbi_block_ragged(jspec, jc, jnp.asarray(lp.numpy()),
                                      jnp.asarray(t0.numpy()),
                                      jnp.asarray(nv.numpy()))
    tc, th = tpl.viterbi_block_ragged(tspec, tc, lp, t0, nv)
    for a, b in zip(tc, jc):
        assert np.array_equal(a.numpy(), np.asarray(b))
    valid = np.arange(24)[:, None] < nv.numpy()[None, :]
    assert valid.any() and not valid.all()
    for g, w in zip(th, jh):
        assert np.array_equal(g.numpy()[valid], np.asarray(w)[valid])


def test_viterbi_p129_wraps_the_int8_winner_as_jax_does():
    """129 phonemes: phnrec_tpu stores the winner as int8, so phoneme 128
    wraps to -128; the port's plain version wraps the same way (the card's
    kernel refuses such a loop, chip_smoke.py)."""
    P, S, B, T = 129, 1, 2, 6
    lp = np.full((B, T, P * S), -5.0, np.float32)
    lp[:, :, 128] = 0.0                    # phoneme 128 wins every frame
    jspec, tspec = _specs(P, S)
    jc, jh = jpl.viterbi_block(jspec, jpl.init_carry(jspec, B),
                               jnp.asarray(lp), jnp.int32(0))
    tc, th = tpl.viterbi_block(tspec, tpl.init_carry(tspec, B),
                               torch.from_numpy(lp), 0)
    assert (np.asarray(jh.max_phn) == -128).all()
    _assert_hist_equal(th, jh)
