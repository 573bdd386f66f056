"""Kernel F's plain version (ops/lrtrace.py: the lrtrace_step_fn frame
loop) against phnrec_tpu's vmapped lax.scan of lrtrace_step_fn
(phnrec_tpu/multistream.py:1017-1036) on the same sink records: state and
both event records equal in every field, with time_pruning 40, 25 and
1e10 (the serving defaults: improveKwdEstim off, the keyword-0 quirk on),
and ragged live rows; and for all four (improveKwdEstim, quirk) pairs at
K 3 and 129.  The host decode of the events and the final flush match
too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phnrec_tpu.decoder import stknet as jst

from phnrec_tpu_torch.decoder import stknet as tst
from phnrec_tpu_torch.ops import lrtrace

N, F, S = 6, 150, 5
WS, FS = np.array([2, 4, 3], np.int32), 1       # word sinks, filler sink


def _records(seed=0):
    """Sink records built to flush often: random-walk values with dead
    stretches (NEG), word starts that jump to the current frame every
    20-80 frames (new hypotheses) and age in between (time pruning)."""
    rng = np.random.default_rng(seed)
    sv = np.cumsum(rng.normal(0, 1, (F, N, S)), axis=0) - 40
    sv[rng.random((F, N, S)) < 0.1] = tst.NEG
    nd = rng.integers(0, 300, N).astype(np.int32)
    seg = rng.integers(20, 80, (1, N, S))
    f = np.arange(F)[:, None, None]
    sw = nd[None, :, None] + f // seg * seg
    nv = np.array([F, 97, 0, F, 1, 133], np.int32)
    return sv.astype(np.float32), sw.astype(np.int32), nd, nv


def _jax_scan(sv, sw, nd, nv, tp):
    step = jst.lrtrace_step_fn(tp, -1e30)
    K = len(WS)

    def one(st, sv_b, sw_b, t0, nv_b):
        tt = t0 + jnp.arange(F, dtype=jnp.int32)
        live = jnp.arange(F) < nv_b
        return jax.lax.scan(step, st, (sv_b[:, WS], sv_b[:, FS],
                                       sw_b[:, WS], tt, live))

    st0 = jax.tree_util.tree_map(
        lambda a: jnp.tile(a[None], (N,) + (1,) * a.ndim),
        jst.lrtrace_init_state(K))
    return jax.vmap(one)(st0, jnp.asarray(sv.transpose(1, 0, 2)),
                         jnp.asarray(sw.transpose(1, 0, 2)),
                         jnp.asarray(nd), jnp.asarray(nv))


@pytest.mark.parametrize("tp,seed", [(40, 0), (1e10, 0), (25, 0), (40, 6)])
def test_plain_matches_jax_scan(tp, seed):
    sv, sw, nd, nv = _records(seed)
    jstate, jev = _jax_scan(sv, sw, nd, nv, tp)
    st, ev = lrtrace.lrtrace_scan_plain(
        tst.lrtrace_init_state(len(WS), N), torch.from_numpy(sv),
        torch.from_numpy(sw), torch.from_numpy(WS), FS,
        torch.from_numpy(nd), torch.from_numpy(nv), tp, -1e30)
    for a, b in zip(st, jstate):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for r in range(2):
        for k in ev[r]:
            np.testing.assert_array_equal(ev[r][k].numpy(),
                                          np.asarray(jev[r][k]),
                                          err_msg=f"rec{r + 1} {k}")
    assert ev[0]["emit"].sum() > 10
    assert (ev[1]["emit"].sum() > 0) == (tp < 1e9)
    assert not ev[0]["emit"][2].any()           # the stream with no frames
    # host decode of each stream's events and the final flush
    kws = ["k0", "k1", "k2"]
    for b in range(N):
        sub = tuple({k: v[b].numpy() for k, v in rec.items()} for rec in ev)
        jsub = tuple({k: np.asarray(v)[b] for k, v in rec.items()}
                     for rec in jev)
        assert tst.decode_lrtrace_events(sub, kws) == [
            tst.KWSHit(**vars(h))
            for h in jst.decode_lrtrace_events(jsub, kws)]
        row = tuple(leaf[b].numpy() for leaf in st)
        jrow = tuple(np.asarray(leaf)[b] for leaf in jstate)
        assert tst.flush_outstanding_candidates(row, kws, -1e30) == [
            tst.KWSHit(**vars(h))
            for h in jst.flush_outstanding_candidates(jrow, kws, -1e30)]


def test_blocks_chain():
    """Two blocks with the state and n_dec passed through equal one."""
    sv, sw, nd, _ = _records(seed=1)
    full = np.full(N, F, np.int32)
    t = torch.from_numpy
    args = (torch.from_numpy(WS), FS)
    s1, e1 = lrtrace.lrtrace_scan_plain(
        tst.lrtrace_init_state(3, N), t(sv), t(sw), *args, t(nd), t(full),
        40, -1e30)
    sa, ea = lrtrace.lrtrace_scan_plain(
        tst.lrtrace_init_state(3, N), t(sv[:70]), t(sw[:70]), *args, t(nd),
        t(full * 0 + 70), 40, -1e30)
    sb, eb = lrtrace.lrtrace_scan_plain(
        sa, t(sv[70:]), t(sw[70:]), *args, t(nd + 70), t(full - 70), 40,
        -1e30)
    for a, b in zip(sb, s1):
        assert torch.equal(a, b)
    for r in range(2):
        for k in e1[r]:
            assert torch.equal(torch.cat([ea[r][k], eb[r][k]], dim=1),
                               e1[r][k])


def test_wrapper_device_rules():
    """CPU tensors run the plain version and count no launch; tensors on
    any other non-CUDA device raise."""
    sv, sw, nd, nv = _records(seed=2)
    t = torch.from_numpy
    args = [tst.lrtrace_init_state(3, N), t(sv), t(sw), t(WS), FS, t(nd),
            t(nv), 40, -1e30]
    before = lrtrace.LAUNCHES
    got = lrtrace.lrtrace_scan(*args)
    want = lrtrace.lrtrace_scan_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
    meta = [tuple(x.to("meta") for x in a) if isinstance(a, tuple) else
            a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="no kernel"):
        lrtrace.lrtrace_scan(*meta)
    assert lrtrace.LAUNCHES == before


def _jax_scan_cols(sv, sw, nd, nv, tp, sp, ws, fs, improve=False,
                   quirk=True):
    """_jax_scan with its own word and filler columns, score pruning and
    LRTrace settings."""
    step = jst.lrtrace_step_fn(tp, sp, improve, quirk)
    Fb, n = sv.shape[:2]

    def one(st, sv_b, sw_b, t0, nv_b):
        tt = t0 + jnp.arange(Fb, dtype=jnp.int32)
        live = jnp.arange(Fb) < nv_b
        return jax.lax.scan(step, st, (sv_b[:, ws], sv_b[:, fs],
                                       sw_b[:, ws], tt, live))

    st0 = jax.tree_util.tree_map(
        lambda a: jnp.tile(a[None], (n,) + (1,) * a.ndim),
        jst.lrtrace_init_state(len(ws)))
    return jax.vmap(one)(st0, jnp.asarray(sv.transpose(1, 0, 2)),
                         jnp.asarray(sw.transpose(1, 0, 2)),
                         jnp.asarray(nd), jnp.asarray(nv))


@pytest.mark.parametrize("K,S", [(1, 4), (33, 34)])
@pytest.mark.parametrize("tp", [40, 1e10])
def test_plain_matches_jax_scan_tie_heavy(K, S, tp):
    """Small-integer sink values (scan_variants' tie-heavy records: lr
    equal to last_lr and to cand_lr on many frames, word starts equal to
    the candidate end), K 1 and 33, score pruning -3: state and both
    event records equal in every field to phnrec_tpu's scan."""
    from phnrec_tpu_torch.devtools.scan_variants import lrtrace_case
    st, sv, sw, ws, fs, nd, nv = lrtrace_case("cpu", 9, 90, K, S,
                                              seed=K + 3, ties=True)
    lr = sv[:, :, ws.long()] - sv[:, :, fs][:, :, None]
    active = (sv[:, :, ws.long()] > tst.NEG / 2) & \
        (sv[:, :, fs] > tst.NEG / 2)[:, :, None]
    same = (lr[1:] == lr[:-1]) & active[1:] & active[:-1]
    assert float(same.float().mean()) > 0.1     # lr == last_lr often
    got_st, got_ev = lrtrace.lrtrace_scan_plain(st, sv, sw, ws, fs, nd, nv,
                                                tp, -3.0)
    jstate, jev = _jax_scan_cols(sv.numpy(), sw.numpy(), nd.numpy(),
                                 nv.numpy(), tp, -3.0, ws.numpy(), fs)
    for a, b in zip(got_st, jstate):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for r in range(2):
        for k in got_ev[r]:
            np.testing.assert_array_equal(got_ev[r][k].numpy(),
                                          np.asarray(jev[r][k]),
                                          err_msg=f"rec{r + 1} {k}")
    assert got_ev[0]["emit"].sum() > 10


@pytest.mark.parametrize("K,ties", [(129, False), (200, False), (200, True)])
def test_plain_matches_jax_scan_past_128_keywords(K, ties):
    """Past the 128 keywords one launch of kernel F takes (the card runs
    groups of 128, keyword 0's candidate end passed from the first group
    to the others): state and both event records equal in every field to
    phnrec_tpu's scan, time pruning 40 (the keyword-0 reference), with
    random-walk records that flush by time pruning and tie-heavy ones."""
    from phnrec_tpu_torch.devtools.scan_variants import lrtrace_case
    st, sv, sw, ws, fs, nd, nv = lrtrace_case("cpu", 6, 150, K, K + 2,
                                              seed=K + ties, ties=ties)
    sp = -3.0 if ties else -1e30
    got_st, got_ev = lrtrace.lrtrace_scan_plain(st, sv, sw, ws, fs, nd, nv,
                                                40, sp)
    jstate, jev = _jax_scan_cols(sv.numpy(), sw.numpy(), nd.numpy(),
                                 nv.numpy(), 40, sp, ws.numpy(), fs)
    for a, b in zip(got_st, jstate):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for r in range(2):
        for k in got_ev[r]:
            np.testing.assert_array_equal(got_ev[r][k].numpy(),
                                          np.asarray(jev[r][k]),
                                          err_msg=f"rec{r + 1} {k}")
    assert got_ev[0]["emit"].sum() > 10
    if not ties:
        # time-pruning flushes, past the first group's keywords too
        assert got_ev[1]["emit"][:, :, 128:].sum() > 0


@pytest.mark.parametrize("improve", [False, True])
@pytest.mark.parametrize("quirk", [True, False])
@pytest.mark.parametrize("K", [3, 129])
def test_plain_matches_jax_scan_settings(improve, quirk, K):
    """LRTrace's two settings (improveKwdEstim re-opens a dumped candidate
    whose end moved; without the quirk each keyword's time pruning reads
    its own candidate end): state and both event records equal to
    phnrec_tpu's scan in every field at the same settings, and the
    settings change the events."""
    from phnrec_tpu_torch.devtools.scan_variants import lrtrace_case
    st, sv, sw, ws, fs, nd, nv = lrtrace_case("cpu", 6, 150, K, K + 2,
                                              seed=K + 2)
    args = (st, sv, sw, ws, fs, nd, nv, 40, -1e30)
    got_st, got_ev = lrtrace.lrtrace_scan_plain(*args, improve, quirk)
    jstate, jev = _jax_scan_cols(sv.numpy(), sw.numpy(), nd.numpy(),
                                 nv.numpy(), 40, -1e30, ws.numpy(), fs,
                                 improve, quirk)
    for a, b in zip(got_st, jstate):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for r in range(2):
        for k in got_ev[r]:
            np.testing.assert_array_equal(got_ev[r][k].numpy(),
                                          np.asarray(jev[r][k]),
                                          err_msg=f"rec{r + 1} {k}")
    if improve or not quirk:
        _, default_ev = lrtrace.lrtrace_scan_plain(*args)
        assert any(not torch.equal(got_ev[r]["emit"], default_ev[r]["emit"])
                   for r in range(2))
