"""Kernel B's plain version (ops/netstep.py: the DenseKWSScan.step loop)
against phnrec_tpu's fused Pallas network block in interpret mode and its
XLA dense scan, on the tiny KWS package's network: records and carry
bit-equal on live entries (Pallas) and everywhere (dense), with ragged
validity, word-time resets, and beam off and 8.0, on normal observations
and on small-integer ones (many tied closure and sink candidates, settled
by the first-maximum rule).  Mirrors tests/test_pallas_netstep.py:35-105.
Also the structure gate, the dense edge tables the kernel reads, the
wrapper's device rules and its limits."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phnrec_tpu.decoder.stknet import DenseKWSScan as JDense
from phnrec_tpu.ops import pallas_netstep as jps
from phnrec_tpu.pipeline import SpeechRec as JSpeechRec

from phnrec_tpu_torch import convert, synth
from phnrec_tpu_torch.decoder.stknet import NEG, OFF_BEAM
from phnrec_tpu_torch.ops import netstep


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    pkg = synth.write_kws_package(tmp_path_factory.mktemp("kws") / "pkg",
                                  "tiny", seed=0)
    jd = JDense(JSpeechRec(pkg).stk_decoder.decoder)
    return jd, convert.dense_kws_from_jax(jd)


def _inputs(td, n=8, F=16, seed=0, ties=False):
    rng = np.random.default_rng(seed)
    # small integers as float32 tie many exits + closure weights (the
    # weights are dyadic), where normal draws almost never do
    obs = (rng.integers(-3, 1, (F, n, td.E)) if ties else
           rng.normal(-3, 2, (F, n, td.E))).astype(np.float32)
    nv = np.array([16, 12, 16, 3, 0, 16, 7, 16], np.int32)[:n]
    nd = rng.integers(0, 50, n).astype(np.int32)
    return obs, nv, nd


@pytest.mark.parametrize("beam", [float(OFF_BEAM), 8.0])
def test_plain_matches_pallas_and_dense_scan(dense, beam):
    _check_against_jax(*dense, *_inputs(dense[1], 8, 16), beam)


@pytest.mark.parametrize("beam", [float(OFF_BEAM), 8.0])
def test_plain_matches_pallas_and_dense_scan_on_ties(dense, beam):
    """Small-integer observations: many closure and sink decisions are
    ties, and the plain version settles them as the XLA dense scan and the
    Pallas block do."""
    jd, td = dense
    obs, nv, nd = _inputs(td, 8, 16, seed=5, ties=True)
    closure, sinks = netstep.count_ties(
        td, td.init_carry(8), torch.from_numpy(obs), torch.from_numpy(nv),
        torch.from_numpy(nd), torch.full((8,), beam))
    assert closure > 50 and sinks > 20
    _check_against_jax(jd, td, obs, nv, nd, beam)


def _check_against_jax(jd, td, obs, nv, nd, beam):
    F, n = obs.shape[:2]
    bm = np.full(n, beam, np.float32)
    car0 = jd.init_carry(n)

    def step(c, x):
        o, i = x
        return jd.step(c, o, jnp.asarray(nd) + 1 + i, i < jnp.asarray(nv),
                       jnp.asarray(bm))

    carr, (sv_r, sw_r) = jax.lax.scan(
        step, car0, (jnp.asarray(obs), jnp.arange(F, dtype=jnp.int32)))
    run = jps.build_net_block_fn(jd, n, interpret=True)
    carp, (sv_p, sw_p) = run(car0, jnp.asarray(obs), jnp.asarray(nv),
                             jnp.asarray(nd), jnp.asarray(bm))
    cart, (sv_t, sw_t) = netstep.net_block_plain(
        td, td.init_carry(n), torch.from_numpy(obs), torch.from_numpy(nv),
        torch.from_numpy(nd), torch.from_numpy(bm))
    # bit-equal to the XLA dense scan everywhere
    np.testing.assert_array_equal(sv_t.numpy(), np.asarray(sv_r))
    np.testing.assert_array_equal(sw_t.numpy(), np.asarray(sw_r))
    for a, b in zip(cart, carr):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the same entries live (> NEG / 2) as in the Pallas kernel, and
    # bit-equal to it on them (dead entries hold different never-winning
    # values there)
    live = sv_t.numpy() > NEG / 2
    assert 0.2 < live.mean() < 1.0
    np.testing.assert_array_equal(np.asarray(sv_p) > NEG / 2, live)
    for m in (0, 2):
        np.testing.assert_array_equal(np.asarray(carp[m]) > NEG / 2,
                                      cart[m].numpy() > NEG / 2)
    for a, b in ((sv_t, sv_p), (sw_t, sw_p)):
        np.testing.assert_array_equal(np.where(live, a.numpy(), 0),
                                      np.where(live, np.asarray(b), 0))
    for k, m in ((0, 0), (1, 0), (2, 2), (3, 2)):
        mask = cart[m].numpy() > NEG / 2
        np.testing.assert_array_equal(
            np.where(mask, cart[k].numpy(), 0),
            np.where(mask, np.asarray(carp[k]), 0), err_msg=f"carry {k}")


def test_carry_passes_between_blocks(dense):
    """Two blocks with the carry and n_dec passed through equal one."""
    _, td = dense
    n, F = 8, 16
    obs, _, nd = _inputs(td, n, F, seed=2)
    full = np.full(n, F, np.int32)
    bm = torch.full((n,), 8.0)
    t = torch.from_numpy
    c1, (sv1, sw1) = netstep.net_block_plain(td, td.init_carry(n),
                                             t(obs), t(full), t(nd), bm)
    ca, (sva, swa) = netstep.net_block_plain(
        td, td.init_carry(n), t(obs[:6]), t(full * 0 + 6), t(nd), bm)
    cb, (svb, swb) = netstep.net_block_plain(
        td, ca, t(obs[6:]), t(full - 6), t(nd + 6), bm)
    assert torch.equal(torch.cat([sva, svb]), sv1)
    assert torch.equal(torch.cat([swa, swb]), sw1)
    for a, b in zip(cb, c1):
        assert torch.equal(a, b)


def test_structure_matches_jax_and_gate_rejects_skip_edge(dense):
    jd, td = dense
    js, ts = jps.extract_structure(jd), netstep.extract_structure(td)
    assert ts["S_M"] == js["S_M"] == 3
    for k in ("w_self", "w_adv", "w_entry", "w_exit"):
        np.testing.assert_array_equal(ts[k], js[k])
    assert isinstance(netstep.build_net_block_fn(td), netstep.NetBlock)
    A_in = td.A_in.copy()
    A_in[td.M + 0, 2] = np.float32(-0.5)      # skip: state 0 -> state 2
    irr = type(td).from_tables(A_in, td.A_ex, td.A_cm, td.R_cm, td.A_cs,
                               td._entry0, td.n_sinks)
    assert netstep.extract_structure(irr) is None
    assert netstep.build_net_block_fn(irr) is None


def test_closure_lists(dense):
    """The dense edge tables the kernel reads: the distinct destination
    columns (the closure's A_cm[:, d], then each sink's A_cs[:, s]) by
    source, -inf on dead edges (<= NEG / 2) and in the padding, each
    destination mapped to its column's row; the reset flags R_cm
    transposed, 0 on dead edges; rows padded to a multiple of 32 and a
    stride of an odd number of 16-byte units."""
    _, td = dense
    blk = netstep.build_net_block_fn(td)
    tab, col_of, reset = (blk._host[k] for k in ("tab", "col_of", "reset"))
    M, S, P, U = td.M, td.n_sinks, blk.P, blk.U
    assert P >= M and P % 4 == 0 and (P // 4) % 2 == 1
    assert tab.shape == (-(-U // 32) * 32, P) and tab.dtype == np.float32
    assert col_of.shape == (M + S,) and col_of.dtype == np.int32
    assert reset.shape == (M, P) and reset.dtype == np.int8
    # each distinct column once, every destination on a row of its own
    # column, dead edges as -inf
    assert len({tab[u].tobytes() for u in range(U)}) == U
    assert set(col_of.tolist()) == set(range(U))
    for d, col in enumerate(np.concatenate([td.A_cm, td.A_cs[:, :S]], 1).T):
        live = col > NEG / 2
        row = tab[col_of[d], :M]
        np.testing.assert_array_equal(row[live], col[live])
        assert np.all(row[~live] == -np.inf)
        if d < M:
            np.testing.assert_array_equal(reset[d, :M],
                                          td.R_cm[:, d] & live)
    assert np.all(tab[U:] == -np.inf) and np.all(tab[:, M:] == -np.inf)
    assert not reset[:, M:].any()
    assert td.R_cm.any() and (td.A_cm <= NEG / 2).any() and U < M + S


def test_wrapper_device_rules(dense):
    """CPU tensors run the plain version and count no launch; tensors on
    any other non-CUDA device raise."""
    _, td = dense
    blk = netstep.build_net_block_fn(td)
    n, F = 8, 5
    obs, nv, nd = _inputs(td, n, F)
    args = (td.init_carry(n), torch.from_numpy(obs),
            torch.from_numpy(np.minimum(nv, F)), torch.from_numpy(nd),
            torch.full((n,), 8.0))
    before = netstep.LAUNCHES
    got = blk(*args)
    want = netstep.net_block_plain(td, *args)
    assert torch.equal(got[1][0], want[1][0])
    meta = tuple(a.to("meta") if isinstance(a, torch.Tensor) else
                 tuple(x.to("meta") for x in a) for a in args)
    with pytest.raises(ValueError, match="no kernel"):
        blk(*meta)
    assert netstep.LAUNCHES == before


@pytest.mark.parametrize("M, S_M, F, n, what", [
    pytest.param(205, 5, 2, 3, "states", id="E-one-past"),
    pytest.param(256, 4, 2 ** 21, 1, "offsets", id="offsets-one-past")])
def test_wrapper_raises_one_past_its_limits(M, S_M, F, n, what,
                                            monkeypatch):
    """The kernel takes E <= MAX_E states (32 a lane of a stream's warp)
    and blocks whose records fit 32-bit offsets: one past either raises
    before anything is built or launched, the limit itself passes, and
    the CPU path (the plain version) still takes the wider net."""
    def no_build(name):
        raise AssertionError(f"built {name}")
    monkeypatch.setattr(netstep._build, "load", no_build)
    td = synth.dense_kws_net(M, S_M, 2)
    E = td.E
    assert E == (netstep.MAX_E + 1 if what == "states" else netstep.MAX_E)
    blk = netstep.build_net_block_fn(td)
    assert blk is not None
    before = netstep.LAUNCHES
    meta = (tuple(t.to("meta") for t in td.init_carry(n)),
            torch.empty((F, n, E), device="meta"),
            torch.zeros(n, dtype=torch.int32, device="meta"),
            torch.zeros(n, dtype=torch.int32, device="meta"),
            torch.zeros(n, device="meta"))
    with pytest.raises(ValueError, match=what):
        blk(*meta)
    assert netstep.LAUNCHES == before
    if what == "states":
        netstep.check_limits(netstep.MAX_E, 1, F, n)
        got = blk(td.init_carry(1), torch.zeros((1, 1, E)),
                  torch.ones(1, dtype=torch.int32),
                  torch.zeros(1, dtype=torch.int32), torch.full((1,), 8.0))
        assert got[1][0].shape == (1, 1, 2)
    else:
        netstep.check_limits(E, 1, F - 1, n)
    with pytest.raises(ValueError, match="sinks"):
        netstep.check_limits(E, 0, 1, 1)


def test_limits_match_the_source():
    """The wrapper's state limit is the one the CUDA source exports (from
    the header it shares with kernel E)."""
    csrc = os.path.join(os.path.dirname(netstep.__file__), "..", "csrc")
    src = open(os.path.join(csrc, "netstep.cu")).read()
    header = open(os.path.join(csrc, "netdense.cuh")).read()
    assert '#include "netdense.cuh"' in src
    assert f"constexpr int MAX_E = {netstep.MAX_E};" in header
    assert "phn_net_block_max_e() { return MAX_E; }" in src
