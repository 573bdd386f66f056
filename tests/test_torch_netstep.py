"""Kernel B's plain version (ops/netstep.py: the DenseKWSScan.step loop)
against phnrec_tpu's fused Pallas network block in interpret mode and its
XLA dense scan, on the tiny KWS package's network: records and carry
bit-equal on live entries (Pallas) and everywhere (dense), with ragged
validity, word-time resets, and beam off and 8.0.  Mirrors
tests/test_pallas_netstep.py:35-105.  Also the structure gate, the
closure lists the kernel walks, and the wrapper's device rules."""

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


def _inputs(td, n=8, F=16, seed=0):
    rng = np.random.default_rng(seed)
    obs = rng.normal(-3, 2, (F, n, td.E)).astype(np.float32)
    nv = np.array([16, 12, 16, 3, 0, 16, 7, 16], np.int32)[:n]
    nd = rng.integers(0, 50, n).astype(np.int32)
    return obs, nv, nd


@pytest.mark.parametrize("beam", [float(OFF_BEAM), 8.0])
def test_plain_matches_pallas_and_dense_scan(dense, beam):
    jd, td = dense
    n, F = 8, 16
    obs, nv, nd = _inputs(td, n, F)
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
    """The per-destination edge lists the kernel walks hold exactly the
    live edges of A_cm (with R_cm) and A_cs, sources ascending."""
    _, td = dense
    blk = netstep.build_net_block_fn(td)
    h = blk._host
    for ptr, src, w, rs, A, R in (
            (h["cm_ptr"], h["cm_src"], h["cm_w"], h["cm_reset"], td.A_cm,
             td.R_cm),
            (h["cs_ptr"], h["cs_src"], h["cs_w"], None, td.A_cs, None)):
        assert len(ptr) == A.shape[1] + 1
        for d in range(A.shape[1]):
            rows = src[ptr[d]: ptr[d + 1]]
            want = np.nonzero(A[:, d] > NEG / 2)[0]
            np.testing.assert_array_equal(rows, want)
            np.testing.assert_array_equal(w[ptr[d]: ptr[d + 1]],
                                          A[want, d])
            if rs is not None:
                np.testing.assert_array_equal(rs[ptr[d]: ptr[d + 1]],
                                              R[want, d])
    assert len(h["cm_src"]) > 0 and len(h["cs_src"]) > 0
    assert blk.threads == 32


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
