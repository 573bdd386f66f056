"""Kernels C' and D''s plain versions (the ragged scan and the
committed-window backtrack) against phnrec_tpu's viterbi_block_ragged and
backtrack_device_committed on the same inputs: carry and valid History
rows bit-equal, Segments equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phnrec_tpu.decoder import phnloop as jpl

from phnrec_tpu_torch.decoder import phnloop as tpl


def _specs(P, S, w_penalty=-4.6875):
    return (jpl.PhnLoopSpec(n_phonemes=P, n_states=S, w_penalty=w_penalty),
            tpl.PhnLoopSpec(n_phonemes=P, n_states=S, w_penalty=w_penalty))


def _lp(rng, B, T, P, S):
    return np.log(rng.dirichlet(np.ones(P * S), size=(B, T))).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _carry_equal(got, want):
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def _valid_rows_equal(got, want, n_valid):
    """History columns compared on rows < n_valid[b] only: rows past it
    are undefined in both."""
    T = got[0].shape[0]
    valid = np.arange(T)[:, None] < n_valid[None, :]
    for g, w, dt in zip(got, want, (np.int8, np.int32, np.float32)):
        g = g.numpy()
        assert g.dtype == dt
        assert np.array_equal(g[valid], np.asarray(w)[valid])


RAGGED = [
    dict(seed=0, P=7, S=3, B=6, T=40),
    dict(seed=1, P=46, S=3, B=5, T=32),       # the CZ loop
    dict(seed=2, P=4, S=1, B=4, T=17),
    dict(seed=3, P=5, S=5, B=3, T=25),
]


@pytest.mark.parametrize("case", RAGGED)
def test_ragged_scan_bit_equal_over_blocks(case):
    """Three ragged blocks from the initial carry with uneven t0 and
    n_valid, including all-dead and all-live rows and a row that never
    moves; the carry after each block and its valid History rows are
    bit-equal to JAX's."""
    P, S, B, T = case["P"], case["S"], case["B"], case["T"]
    rng = np.random.default_rng(case["seed"])
    jspec, tspec = _specs(P, S)
    jc, tc = jpl.init_carry(jspec, B), tpl.init_carry(tspec, B)
    t0 = rng.integers(0, 300, B).astype(np.int32)
    for blk in range(3):
        lp = _lp(rng, B, T, P, S)
        nv = rng.integers(0, T + 1, B).astype(np.int32)
        nv[0], nv[1 % B], nv[-1] = T, 0, 0           # live, dead, never
        jc, jh = jpl.viterbi_block_ragged(jspec, jc, jnp.asarray(lp),
                                          jnp.asarray(t0), jnp.asarray(nv))
        tc, th = tpl.viterbi_block_ragged(tspec, tc, _t(lp), _t(t0), _t(nv))
        _carry_equal(tc, jc)
        _valid_rows_equal(th, jh, nv)
        t0 = t0 + nv
    # the row fed nothing still holds the initial carry
    init = tpl.init_carry(tspec, B)
    for a, b in zip(tc, init):
        assert torch.equal(a[..., -1], b[..., -1])


def test_ragged_all_live_equals_uniform_scan():
    """With every row live and one t0, C' is C: carry and History equal
    kernel C's plain version."""
    P, S, B, T = 7, 3, 4, 30
    rng = np.random.default_rng(5)
    _, tspec = _specs(P, S)
    carry = tpl.init_carry(tspec, B)
    lp = _t(_lp(rng, B, T, P, S))
    rc, rh = tpl.viterbi_block_ragged(
        tspec, carry, lp, torch.full((B,), 11, dtype=torch.int32),
        torch.full((B,), T, dtype=torch.int32))
    uc, uh = tpl.viterbi_block(tspec, carry, lp, 11)
    for a, b in zip((*rc, *rh), (*uc, *uh)):
        assert torch.equal(a, b)


def _window_case(seed, B=5, T=60, P=7, S=3):
    """A scan of T + 40 frames from frame 0 (entry frames global) and a
    retained window of T rows per stream starting at row_offset[b], with
    committed boundaries frame0[b] before, at and inside the window."""
    rng = np.random.default_rng(seed)
    jspec, tspec = _specs(P, S)
    lp = _lp(rng, B, T + 40, P, S)
    full = jpl.viterbi_scan_batch(jspec, jnp.asarray(lp))
    ro = rng.integers(0, 41, B).astype(np.int32)
    rows = ro[None, :] + np.arange(T)[:, None]
    win = tuple(np.take_along_axis(np.asarray(a), rows, axis=0) for a in full)
    f0 = (ro + rng.integers(0, 25, B)).astype(np.int32)
    f0[0] = max(int(ro[0]) - 3, 0)                  # boundary before it
    f0[1 % B] = ro[1 % B]                           # at its first row
    n_rel = rng.integers(0, T + 1, B).astype(np.int32)
    n_rel[0] = T
    n_rel[-1] = 0                                   # nothing retained
    return jspec, tspec, win, n_rel, f0, ro


@pytest.mark.parametrize("seed", range(4))
def test_committed_backtrack_equal(seed):
    jspec, tspec, win, n_rel, f0, ro = _window_case(seed)
    want = jpl.backtrack_device_committed(
        jspec, jpl.History(*(jnp.asarray(a) for a in win)),
        jnp.asarray(n_rel), jnp.asarray(f0), jnp.asarray(ro))
    got = tpl.backtrack_device_committed(
        tspec, tpl.History(*(_t(a) for a in win)), _t(n_rel), _t(f0),
        _t(ro))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        assert np.array_equal(g.numpy(), w)


# kernel D' over numpy-made windows: a serving run's length, int32
# starts (T >= 2^15), hops of exactly S frames and rows of one segment
SYNTHETIC = {
    "long_T6146_B3": dict(seed=31, B=3, T=6146),
    "i32_T33000_B2": dict(seed=32, B=2, T=33000),
    "hops_exactly_S3": dict(seed=33, B=5, T=384, hop=(3, 4)),
    "one_segment": dict(seed=34, B=5, T=300, one_segment=True),
}


@pytest.mark.parametrize("case", SYNTHETIC)
def test_committed_backtrack_synthetic_window_equal(case):
    """The port's D' (its plain version here) against phnrec_tpu's
    backtrack_device_committed on a window whose row i is global frame
    row_offset[b] + i (entry frames global), with the boundary before, at,
    inside and past the window and an empty window: every field equal, the
    same dtype."""
    kw = SYNTHETIC[case]
    B, T = kw["B"], kw["T"]
    hop = kw.get("hop", (3, 22))
    rng = np.random.default_rng(kw["seed"])
    jspec, tspec = _specs(46, hop[0])
    ro = rng.integers(0, 101, B)
    L = rng.integers(hop[0], hop[1], (T, B))
    ent = np.maximum(ro[None, :] + np.arange(T)[:, None] + 1 - L, 0)
    if kw.get("one_segment"):
        ent[:, ::2] = 0
    max_phn = rng.integers(0, 46, (T, B)).astype(np.int8)
    alpha = rng.normal(-50, 30, (T, B)).astype(np.float32)
    n_rel = rng.integers(1, T + 1, B)
    n_rel[0] = T
    n_rel[-1] = 0
    f0 = np.choose(np.arange(B) % 4, [ro - 5, ro, ro + n_rel // 2,
                                      ro + n_rel + 3])
    f0[0] = ro[0]
    win = (max_phn, ent.astype(np.int32), alpha)
    args = [a.astype(np.int32) for a in (n_rel, f0, ro)]
    want = jpl.backtrack_device_committed(
        jspec, jpl.History(*(jnp.asarray(a) for a in win)),
        *(jnp.asarray(a) for a in args))
    got = tpl.backtrack_device_committed(
        tspec, tpl.History(*(_t(a) for a in win)), *(_t(a) for a in args))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        assert np.array_equal(g.numpy(), w)
    assert got.start.dtype == (torch.int32 if T >= 2 ** 15 else torch.int16)
    if "hop" in kw:
        assert int(got.count[0]) == -(-T // hop[0])
    if kw.get("one_segment"):
        assert (got.count[::2] <= 1).all()


def test_committed_backtrack_labels_equal_host_walk():
    """The segments of D', turned into labels, are the host walk's
    (backtrack_committed) on each stream's window, boundary clamp
    included; D' with frame0 = row_offset = 0 is D."""
    jspec, tspec, win, n_rel, f0, ro = _window_case(9, B=4)
    f0 = np.maximum(f0, ro)       # a server drops only committed rows
    names = [f"p{i}" for i in range(jspec.n_phonemes)]
    hist = tpl.History(*(_t(a) for a in win))
    segs = tpl.fetch_segments(tpl.backtrack_device_committed(
        tspec, hist, _t(n_rel), _t(f0), _t(ro)), cap=1000)
    n_glob = (n_rel + ro).astype(np.int64)
    got = tpl.labels_from_segments(segs, n_glob, names, row_offset=ro)
    for b in range(4):
        col = jpl.History(*(a[: n_rel[b], b] for a in win))
        want = jpl.backtrack_committed(col, int(ro[b]), int(f0[b]), 0.0,
                                       names)
        key = lambda ls: [(l.start_frames, l.end_frames, l.name)  # noqa
                          for l in ls]
        assert key(got[b]) == key(want)
    n_pos = torch.clamp(_t(n_rel), min=1)
    zero = torch.zeros(4, dtype=torch.int32)
    for a, b in zip(tpl.backtrack_device_committed(tspec, hist, n_pos, zero,
                                                   zero),
                    tpl.backtrack_device(tspec, hist, n_pos)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("horizon", ["behind_labels", "inside_first",
                                     "at_boundary"])
def test_commit_labels(horizon):
    """The fixed-lag commit policy that StreamingRecognizer and both
    MultiStreamRecognizer commits share, on a window's walk: labels ending
    by the horizon commit, and the new boundary like (the committed likes
    summed) is exactly the path's score at the boundary, as phnrec_tpu's
    host commit reads it; with no label ending by the horizon, the first
    label is split there with the given like; a horizon at the boundary
    commits nothing."""
    _, _, win, _, _, ro = _window_case(3, B=2)
    r = int(ro[0])
    col = tpl.History(*(a[:, 0] for a in win))
    labels = tpl.backtrack_committed(col, r, r, 0.0,
                                     [f"p{i}" for i in range(7)])
    first = labels[0]
    assert len(labels) >= 3 and first.end_frames - first.start_frames >= 2
    h = {"behind_labels": labels[-2].end_frames + 1,
         "inside_first": first.start_frames + 1,
         "at_boundary": r}[horizon]
    got = tpl.commit_labels(labels, h, lambda: -1.25)
    if horizon == "at_boundary":
        assert got is None
        return
    commit, frame0, alpha0 = got
    if horizon == "inside_first":
        assert commit == [type(first)(first.start_frames, h, first.name,
                                      -1.25)]
        assert (frame0, alpha0) == (h, -1.25)
        return
    assert commit == labels[:-1] and frame0 == labels[-2].end_frames
    assert alpha0 == float(col.alpha[frame0 - 1 - r])


@pytest.mark.parametrize("P", [7, 33, 128])
@pytest.mark.parametrize("S", [1, 5])
@pytest.mark.parametrize("ties", ["ints", "zeros"])
def test_ragged_tie_heavy_bit_equal(P, S, ties):
    """Kernel C''s plain version against phnrec_tpu's viterbi_block_ragged
    on tie-heavy small-integer observations with -0.0 (scan_variants'
    "ints" and "zeros" cases: loop maxima tied across phonemes, -0.0
    against +0.0, cur == prev), two ragged blocks chained through the
    carry and t0 + n_valid: carry and valid History rows equal (as
    floats: phnrec_tpu records jnp.max, whose zero may carry another sign
    than the winner's own value that the port records)."""
    from phnrec_tpu_torch.devtools.scan_variants import viterbi_case
    B, T = 5, 24
    tspec, lp, t0, nv = viterbi_case("cpu", P, S, B, T, P * S, seed=7 * P + S,
                                     ties=ties)
    jspec = jpl.PhnLoopSpec(*tspec)
    tc, jc = tpl.init_carry(tspec, B), jpl.init_carry(jspec, B)
    for x, n_v in ((lp, nv), (lp.flip(1).contiguous(), nv.flip(0))):
        jc, jh = jpl.viterbi_block_ragged(
            jspec, jc, jnp.asarray(x.numpy()), jnp.asarray(t0.numpy()),
            jnp.asarray(n_v.numpy()))
        tc, th = tpl.viterbi_block_ragged(tspec, tc, x, t0, n_v)
        _carry_equal(tc, jc)
        _valid_rows_equal(th, jh, n_v.numpy())
        t0 = t0 + n_v
