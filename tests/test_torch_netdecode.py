"""Kernel E's plain version and the decode-mode dense step against
phnrec_tpu, on the CPU.

* ``DenseKWSScan``'s weight and edge-id tables built by the port equal
  phnrec_tpu's (tiny and CZ stkint phoneme loops, a keyword network);
* ``init_carry_decode`` / ``step_decode`` frame by frame against
  phnrec_tpu's ``DenseKWSScan`` (the same float32 max-plus sums and
  first-maximum argmaxes: carry and records equal everywhere, dead entries
  included), on ``synth.dense_kws_net`` nets and the tiny and CZ loops,
  with tie-heavy observations, a beam and dead frames;
* ``net_decode_block_plain`` against a ``lax.scan`` of JAX's step with
  ragged valid counts, ids as int16;
* the host tables kernel E reads (``id_tables`` beside kernel B's
  ``dense_tables``), through a numpy model of the kernel's arithmetic,
  against the plain version on live entries (``compare_live``);
* ``traceback_host`` against phnrec_tpu's on stitched windows with
  ``boundary`` / ``frame_offset`` / ``like_offset``;
* the wrapper's device rules."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phnrec_tpu.decoder.stknet import DenseKWSScan as JDense
from phnrec_tpu.pipeline import SpeechRec as JSpeechRec

from phnrec_tpu_torch import convert, synth
from phnrec_tpu_torch.decoder.stknet import NEG, OFF_BEAM, DenseKWSScan
from phnrec_tpu_torch.ops import _build, netdecode, netstep
from phnrec_tpu_torch.pipeline import SpeechRec

TABLES = ("A_in", "A_ex", "A_cm", "R_cm", "A_cs", "I_in", "I_ex", "I_cm",
          "I_cs", "_entry0", "_entry_edge0")


@pytest.fixture(scope="module")
def packages(tmp_path_factory):
    root = tmp_path_factory.mktemp("netdecode")
    return {"tiny": synth.write_stk_decode_package(root / "tiny", "tiny"),
            "cz": synth.write_stk_decode_package(root / "cz", "cz"),
            "kws": synth.write_kws_package(root / "kws", "tiny", seed=2),
            "words": _decode_mode(synth.write_kws_package(
                root / "words", "tiny", seed=1))}


def _decode_mode(pkg):
    """A KWS package as a decode-mode word network, word penalty +8 so the
    best paths cross keyword edges (as tests/test_torch_stkdecode.py)."""
    cfg = os.path.join(pkg, "config")
    with open(cfg) as f:
        text = f.read()
    with open(cfg, "w") as f:
        f.write(text.replace("mode=kws", "mode=decode").replace(
            "wpenalty=-4.6875", "wpenalty=8.0"))
    return pkg


@pytest.fixture(scope="module")
def nets(packages):
    """name -> (JAX DenseKWSScan, the port's from JAX's tables, the port's
    from its own decoder)."""
    out = {}
    for name, pkg in packages.items():
        jd = JDense(JSpeechRec(pkg).stk_decoder.decoder)
        td = DenseKWSScan(SpeechRec(pkg, device="cpu").stk_decoder.decoder)
        out[name] = (jd, convert.dense_kws_from_jax(jd), td)
    for name, (M, S_M, S, seed) in {"rand": (7, 3, 2, 1),
                                    "rand_wide": (40, 2, 5, 2)}.items():
        td = synth.dense_kws_net(M, S_M, S, seed=seed)
        out[name] = (_jax_dense(td), td, td)
    return out


def _jax_dense(td):
    """phnrec_tpu's DenseKWSScan over the port's tables (its steps read
    only these attributes)."""
    jd = JDense.__new__(JDense)
    for k in TABLES:
        setattr(jd, k, jnp.asarray(getattr(td, k)))
    jd._entry0, jd._entry_edge0 = (np.asarray(td._entry0),
                                   np.asarray(td._entry_edge0))
    jd.M, jd.E, jd.n_sinks = td.M, td.E, td.n_sinks
    return jd


@pytest.mark.parametrize("name", ["tiny", "cz", "kws"])
def test_tables_match_jax(nets, name):
    jd, _, td = nets[name]
    for k in TABLES:
        np.testing.assert_array_equal(getattr(td, k),
                                      np.asarray(getattr(jd, k)), err_msg=k)


def _obs(n, F, E, seed, ties):
    rng = np.random.default_rng(seed)
    # small integers tie many in-model, closure and sink candidates
    return (rng.integers(-3, 1, (n, F, E)) if ties else
            rng.normal(-3, 2, (n, F, E))).astype(np.float32)


CASES = [(name, beam, ties) for name in ("rand", "rand_wide", "tiny", "cz",
                                         "kws")
         for beam, ties in ((float(OFF_BEAM), False), (4.0, False),
                            (float(OFF_BEAM), True), (2.0, True))]


@pytest.mark.parametrize("name, beam, ties", CASES,
                         ids=[f"{n}-{b:g}-{'ties' if t else 'normal'}"
                              for n, b, t in CASES])
def test_step_decode_matches_jax(nets, name, beam, ties):
    """Frame by frame from init_carry_decode, streams dead on some frames:
    carry and records equal to JAX's everywhere."""
    jd, _, td = nets[name]
    n, F = 5, 12
    obs = _obs(n, F, td.E, 3, ties)
    live = np.random.default_rng(4).random((F, n)) < 0.8
    bm = np.full(n, beam, np.float32)
    jc = jd.init_carry_decode(n)
    tc = td.init_carry_decode(n)
    for a, b in zip(tc, jc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for f in range(F):
        jc, jr = jd.step_decode(jc, jnp.asarray(obs[:, f]),
                                jnp.asarray(live[f]), jnp.asarray(bm))
        tc, tr = td.step_decode(tc, torch.from_numpy(obs[:, f]),
                                torch.from_numpy(live[f]),
                                torch.from_numpy(bm))
        for a, b in zip(tc, jc):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert sorted(tr) == sorted(jr)
        for k in tr:
            np.testing.assert_array_equal(tr[k].numpy(), np.asarray(jr[k]),
                                          err_msg=k)


@pytest.mark.parametrize("name", ["rand", "tiny", "cz"])
def test_block_plain_matches_lax_scan(nets, name):
    """net_decode_block_plain over a block with ragged valid counts (0, a
    few, all) against a lax.scan of JAX's step, records [n, F, .] with
    int16 ids, and the carry."""
    jd, _, td = nets[name]
    n, F = 4, 20
    obs = _obs(n, F, td.E, 6, ties=True)
    nv = np.array([20, 7, 0, 13], np.int32)
    beam = np.array([OFF_BEAM, 3.0, OFF_BEAM, 1.5], np.float32)

    def step(c, x):
        o, i = x
        return jd.step_decode(c, o, i < jnp.asarray(nv), jnp.asarray(beam))

    jc, jr = jax.lax.scan(step, jd.init_carry_decode(n),
                          (jnp.asarray(obs.transpose(1, 0, 2)),
                           jnp.arange(F)))
    tc, tr = netdecode.net_decode_block_plain(
        td, td.init_carry_decode(n), torch.from_numpy(obs),
        torch.from_numpy(nv), torch.from_numpy(beam), torch.int16)
    for a, b in zip(tc, jc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for k in netdecode.RECORDS:
        want = np.moveaxis(np.asarray(jr[k]), 0, 1)
        if k in netdecode.ID_KEYS:
            assert tr[k].dtype == torch.int16
            want = want.astype(np.int16)
        np.testing.assert_array_equal(tr[k].numpy(), want, err_msg=k)


def _kernel_model(blk, carry, obs, n_valid, beam):
    """Kernel E's arithmetic in numpy on its host tables: the structured
    in-model pass (ties entry > adv > self) with the winner's id from
    id_in, the beam, the exits, and per destination column the first
    strictly greater x[r] + tab[col_of[d], r] from NEG over all P sources,
    its id from ids[d]."""
    h = blk._host
    M, E, S, S_M, P = blk.M, blk.E, blk.S, blk.S_M, blk.P
    a, en, eg = (c.numpy().copy() for c in carry)
    obs = obs.numpy()
    n, F = obs.shape[:2]
    e = np.arange(E)
    mo, last = e // S_M, np.arange(M) * S_M + S_M - 1
    tab, col, ids = h["tab"][h["col_of"]], h["col_of"], h["ids"]
    recs = {k: np.zeros((n, F, w), np.float32 if k in ("entry_val",
                                                         "sink_val")
                        else np.int32)
            for k, w in (("in_am", E), ("ex_am", M), ("cm_am", M),
                         ("entry_edge", M), ("entry_val", M),
                         ("sink_val", S), ("cs_am", S))}
    for f in range(F):
        recs["entry_val"][:, f], recs["entry_edge"][:, f] = en, eg
        recs["ex_am"][:, f] = h["id_exit"]
        prev = np.concatenate([np.full((n, 1), NEG, np.float32),
                               a[:, :-1]], 1)
        v, sel = a + h["w_self"], np.zeros((n, E), np.int64)
        adv = prev + h["w_adv"]
        sel = np.where(adv >= v, 1, sel)
        v = np.where(adv >= v, adv, v)
        ent = en[:, mo] + h["w_entry"]
        sel = np.where(ent >= v, 2, sel)
        v = np.where(ent >= v, ent, v)
        na = v + obs[:, f]
        recs["in_am"][:, f] = h["id_in"][e, sel]
        thresh = na.max(1, keepdims=True) - beam.numpy()[:, None]
        na = np.where(na >= thresh, na, NEG).astype(np.float32)
        x = np.zeros((n, P), np.float32)
        x[:, :M] = na[:, last] + h["w_exit"]
        c = x[:, None, :] + tab[None]                      # [n, D, P]
        best = c.max(2)
        k = np.where(best > NEG, c.argmax(2), -1)
        vv = np.maximum(best, NEG).astype(np.float32)
        idv = np.where(k >= 0, ids[np.arange(M + S)[None], np.maximum(k, 0)],
                       -1)
        recs["cm_am"][:, f], recs["cs_am"][:, f] = idv[:, :M], idv[:, M:]
        recs["sink_val"][:, f] = vv[:, M:]
        live = (f < n_valid.numpy())[:, None]
        en = np.where(live, np.where(vv[:, :M] >= thresh, vv[:, :M], NEG),
                      en).astype(np.float32)
        eg = np.where(live, idv[:, :M], eg)
        a = np.where(live, na, a)
    assert col.shape == (M + S,)
    return ((torch.from_numpy(a), torch.from_numpy(en),
             torch.from_numpy(eg.astype(np.int32))),
            {k: torch.from_numpy(v) for k, v in recs.items()})


@pytest.mark.parametrize("name", ["rand", "rand_wide", "tiny", "cz", "kws"])
@pytest.mark.parametrize("ties", [False, True], ids=["normal", "ties"])
def test_kernel_tables_model_matches_plain(nets, name, ties):
    """The kernel's host tables, run through a numpy model of its
    arithmetic, give the plain version's values bit for bit where live and
    its ids where their values are live, carry included."""
    _, _, td = nets[name]
    blk = netdecode.build_net_decode_fn(td)
    assert isinstance(blk, netdecode.NetDecode)
    n, F = 6, 16
    obs = torch.from_numpy(_obs(n, F, td.E, 8, ties))
    nv = torch.tensor([16, 9, 0, 16, 3, 16], dtype=torch.int32)
    for beam in (float(OFF_BEAM), 3.0):
        bm = torch.full((n,), beam)
        carry = td.init_carry_decode(n)
        want = netdecode.net_decode_block_plain(td, carry, obs, nv, bm,
                                                values=True)
        got = _kernel_model(blk, carry, obs, nv, bm)
        checks = netdecode.compare_live(got, want)
        assert all(checks.values()), {k: v for k, v in checks.items()
                                      if not v}
        live = want[1]["entry_val"] > NEG / 2
        assert live.any() and (want[1]["sink_val"] > NEG / 2).any()


def test_wrapper_device_rules(nets):
    """On CPU tensors the wrapper is the plain version and counts nothing;
    on a device that is not CUDA it raises before building; an irregular
    network gets no kernel E."""
    _, _, td = nets["rand"]
    blk = netdecode.build_net_decode_fn(td)
    n, F = 3, 5
    args = (td.init_carry_decode(n), torch.from_numpy(_obs(n, F, td.E, 9,
                                                            True)),
            torch.tensor([5, 2, 0], dtype=torch.int32),
            torch.full((n,), float(OFF_BEAM)))
    before = netdecode.LAUNCHES
    got = blk(*args, id_dtype=torch.int16)
    want = netdecode.net_decode_block_plain(td, *args, torch.int16)
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    assert all(torch.equal(got[1][k], want[1][k]) for k in want[1])
    meta = tuple(t.to("meta") for t in args[0]), *(t.to("meta")
                                                   for t in args[1:])
    with pytest.raises(ValueError, match="no kernel"):
        blk(*meta)
    assert netdecode.LAUNCHES == before
    A_in = td.A_in.copy()
    A_in[td.M + 0, 2] = np.float32(-0.5)      # skip: state 0 -> state 2
    irr = DenseKWSScan.from_tables(A_in, td.A_ex, td.A_cm, td.R_cm, td.A_cs,
                                   td._entry0, td.n_sinks)
    assert netdecode.build_net_decode_fn(irr) is None
    assert netstep.extract_structure(irr) is None


def test_limits_match_the_source():
    src = open(_build.CSRC / "netdecode.cu").read()
    header = open(_build.CSRC / "netdense.cuh").read()
    assert '#include "netdense.cuh"' in src
    assert f"constexpr int MAX_E = {netdecode.MAX_E};" in header
    with pytest.raises(ValueError, match="kernel E"):
        netdecode.check_limits(netdecode.MAX_E + 1, 1, 4, 4)


def test_instance_plan_matches_the_source():
    """Kernel E's instance plan (ops/netdecode.py) and the redux
    instance's limits in csrc/netdecode.cu and netdense.cuh agree; the CZ
    loop takes the redux instance at either id width, wider nets the
    general one."""
    import re
    src = open(_build.CSRC / "netdecode.cu").read()
    header = open(_build.CSRC / "netdense.cuh").read()
    assert f"constexpr int RED_COLUMNS = {netdecode.REDUX_COLUMNS};" in src
    assert f"constexpr int RED_EPL = {netdecode.REDUX_EPL};" in src
    assert "U <= RED_COLUMNS && D <= 64 && epl_k <= RED_EPL" in src
    epls = re.search(r"constexpr int EPLS\[\] = \{([^}]*)\};", header)
    assert tuple(int(v) for v in epls.group(1).split(",")) == netdecode.EPLS
    for E, D, U, id16, want in ((138, 47, 2, True, "redux"),
                                (138, 47, 2, False, "redux"),
                                (256, 64, 4, True, "redux"),
                                (257, 64, 4, True, "general"),
                                (200, 64, 4, False, "redux"),
                                (300, 64, 4, False, "general"),
                                (138, 65, 2, True, "general"),
                                (144, 52, 12, True, "general"),
                                (1020, 345, 200, False, "general")):
        assert netdecode.plan_instance(E, D, U, id16) == want, (E, D, U)


@pytest.mark.parametrize("which", ["tiny", "words"])
def test_traceback_host_matches_jax(packages, which):
    """traceback_host over a whole utterance's records, over the window
    after a commit point (boundary, frame_offset, like_offset) and over a
    prefix of it, equals phnrec_tpu's on the same records."""
    pkg = packages[which]
    jdec = JSpeechRec(pkg).stk_decoder.decoder
    tdec = SpeechRec(pkg, device="cpu").stk_decoder.decoder
    rng = np.random.default_rng(11)
    D = int(tdec.c.obs_index.max()) + 1
    T = 150
    lp = np.log(rng.dirichlet(np.full(D, 0.3), size=T)).astype(np.float32)
    recs = {k: np.asarray(v) for k, v in jdec._run_scan(lp).items()}
    checked = 0
    for cut, end, boundary in ((0, T, False), (40, T, True),
                               (40, 110, True), (0, 77, False)):
        rec = {k: v[cut:end] for k, v in recs.items()}
        like = float(recs["entry_val"][cut].max()) if cut else 0.0
        kw = dict(frame_offset=cut, boundary=boundary, like_offset=like)
        want = jdec.traceback_host(rec, **kw)
        got = tdec.traceback_host(rec, **kw)
        assert [vars(a) for a in got] == [vars(b) for b in want]
        checked += bool(want)
    assert checked >= 2
