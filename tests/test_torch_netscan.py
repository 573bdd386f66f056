"""Kernels G and H's plain versions against phnrec_tpu on the same
numpy-seeded inputs: the edge-list scan's nine record arrays against
``NetworkDecoder._scan_batch`` / ``scan_block`` bit for bit on valid
frames (float values equal; +0.0 and -0.0 may differ where a max picks
between them), the traceback's outputs against ``_traceback_batch``
(frame0 = -1 and frame0 >= 0 rows, rows that never reach the terminal
sink), and ``convert.network_tables_from_jax`` against the port's own
compilation.  Networks: the tiny and CZ-width phoneme loops, the tiny KWS
net in decode mode, a random word network with isolated destinations and
one whose closure rows repeat with other edge ids (and the EN KWS net
for kernel G's tables).  Kernel G's distinct-row tables
(``netscan.slot_arrays``) are read by a plain reduction of their own and
held to ``netscan_plain`` and to JAX."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phnrec_tpu.decoder import stknet as jst
from phnrec_tpu.io import mmf as jmmf
from phnrec_tpu.io import stknet as jnet
from phnrec_tpu.pipeline import SpeechRec as JSpeechRec

from phnrec_tpu_torch import convert, netgen, synth
from phnrec_tpu_torch.decoder import stknet as tst
from phnrec_tpu_torch.io import mmf as tmmf
from phnrec_tpu_torch.io import stknet as tnet
from phnrec_tpu_torch.ops import netscan, nettrace
from phnrec_tpu_torch.pipeline import SpeechRec

NETS = ("tiny_loop", "cz_loop", "kws_decode", "random", "repeated_rows")
FIELDS = ("in_src", "in_entry", "in_w", "in_dense", "ex_src", "ex_w",
          "ex_dense", "cm_src", "cm_w", "cm_reset", "cm_dense", "cs_src",
          "cs_w", "cs_dense")


def _loop_decoders(root, n_phonemes):
    """The phoneme loop of benchmarks/stkint_batch.py (netgen's HMMs and
    loop network from a phoneme list, wpenalty -4.6875) compiled by both
    packages."""
    os.makedirs(root, exist_ok=True)
    phn = os.path.join(root, "phonemes")
    with open(phn, "w") as f:
        f.write("".join(f"ph{i:02d}\n" for i in range(n_phonemes)))
    models, net = os.path.join(root, "models"), os.path.join(root, "net")
    netgen.phn_list_to_hmm_defs(phn, models, 3)
    netgen.phn_list_to_phn_loop(phn, net, "oth")
    j = jst.NetworkDecoder(jst.compile_network(
        jnet.parse_stk_network(net), jmmf.parse_mmf(models), -4.6875, 1.0))
    t = tst.NetworkDecoder(tst.compile_network(
        tnet.parse_stk_network(net), tmmf.parse_mmf(models), -4.6875, 1.0))
    return j, t


def _to_jax_compiled(c):
    """The port's CompiledNetwork as phnrec_tpu's (same fields)."""
    fields = {f.name: getattr(c, f.name)
              for f in dataclasses.fields(tst.CompiledNetwork)}
    fields["closure"] = [jst.ClosureEdge(**dataclasses.asdict(e))
                         for e in c.closure]
    return jst.CompiledNetwork(**fields)


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    root = tmp_path_factory.mktemp("nets")
    out = {"tiny_loop": _loop_decoders(str(root / "tiny"), 4),
           "cz_loop": _loop_decoders(str(root / "cz"), 46)}
    pkg = synth.write_kws_package(root / "kws", "tiny", seed=0)
    cfg = os.path.join(pkg, "config")
    with open(cfg) as f:
        text = f.read()
    with open(cfg, "w") as f:
        f.write(text.replace("mode=kws", "mode=decode"))
    jd = JSpeechRec(pkg).stk_decoder
    td = SpeechRec(pkg, device="cpu").stk_decoder
    assert jd.mode == td.mode == "decode"
    out["kws_decode"] = (jd.decoder, td.decoder)
    c = synth.random_network(12, seed=3)
    out["random"] = (jst.NetworkDecoder(_to_jax_compiled(c)),
                     tst.NetworkDecoder(c))
    c = synth.repeated_rows_network(16, seed=4)
    out["repeated_rows"] = (jst.NetworkDecoder(_to_jax_compiled(c)),
                            tst.NetworkDecoder(c))
    return out


@pytest.fixture(scope="module")
def en_kws(tmp_path_factory):
    """The EN KWS package's network (KWS mode) in both packages."""
    pkg = synth.write_kws_package(tmp_path_factory.mktemp("en") / "en",
                                  "en", seed=0)
    return (JSpeechRec(pkg).stk_decoder.decoder,
            SpeechRec(pkg, device="cpu").stk_decoder.decoder)


def _obs(dec, B, T, seed, ties=False):
    """[B, T, E] per-state observations from seeded log posteriors;
    ``ties``: multiples of -1/4 with signed zeros, so maxima tie."""
    rng = np.random.default_rng(seed)
    D = int(dec.c.obs_index.max()) + 1
    if ties:
        lp = -rng.integers(0, 8, (B, T, D)).astype(np.float32) / 4
        lp[rng.random((B, T, D)) < 0.1] = -0.0
    else:
        lp = np.log(rng.dirichlet(np.ones(D), size=(B, T))).astype(
            np.float32)
    return lp[..., dec.c.obs_index]


def _assert_records_equal(want, got, n_valid):
    assert set(got) == set(want) == set(netscan.RECORDS)
    for k, w in want.items():
        g = got[k].numpy()
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, k
        for b, n in enumerate(n_valid):
            n = min(int(n), g.shape[1])
            assert np.array_equal(g[b, :n], w[b, :n]), (k, b)


SCENARIOS = {
    # name: (B, T, beam, ties)
    "ragged_off_beam": (5, 40, None, False),
    "tight_beam": (4, 30, 3.0, False),
    "ties": (4, 30, None, True),
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
@pytest.mark.parametrize("net", NETS)
def test_scan_records_match_jax(nets, net, scenario):
    jd, td = nets[net]
    B, T, beam, ties = SCENARIOS[scenario]
    obs = _obs(td, B, T, seed=len(net) + B, ties=ties)
    nv = np.asarray([T, T - 7, 1, 0, T // 2][:B], np.int32)
    jb = jst.OFF_BEAM if beam is None else np.float32(beam)
    want = jax.tree_util.tree_map(np.asarray, jd._scan_batch(
        jnp.asarray(obs), jnp.asarray(nv), jnp.float32(jb)))
    got = td._scan_batch(torch.from_numpy(obs), torch.from_numpy(nv), beam)
    _assert_records_equal(want, got, nv)
    # some sink is reached: the records carry live paths
    assert (np.asarray(want["sink_val"]) > -1e29).any()


@pytest.mark.parametrize("net", NETS)
def test_scan_block_carried(nets, net):
    """Two blocks chained through the carry: the second starts at per-row
    t0 > 0 with absolute n_valid, records and carry as JAX's scan_block
    row by row."""
    jd, td = nets[net]
    B, T1, T2 = 3, 17, 23
    obs = _obs(td, B, T1 + T2, seed=7)
    nv = np.asarray([T1 + T2, T1 + 5, T1 - 3], np.int32)
    beam = np.float32(6.0)
    c1, _ = td.scan_block(td.init_carry("cpu", B),
                          torch.from_numpy(obs[:, :T1].copy()), 0,
                          torch.from_numpy(nv), beam)
    c2, got = td.scan_block(c1, torch.from_numpy(obs[:, T1:].copy()),
                            torch.full((B,), T1, dtype=torch.int32),
                            torch.from_numpy(nv), beam)
    for b in range(B):
        jc1, _ = jd.scan_block(jd.init_carry(), jnp.asarray(obs[b, :T1]),
                               0, jnp.int32(nv[b]), jnp.float32(beam))
        jc2, jr = jd.scan_block(jc1, jnp.asarray(obs[b, T1:]), T1,
                                jnp.int32(nv[b]), jnp.float32(beam))
        for g, w in zip(c2, jc2):
            assert np.array_equal(g[b].numpy(), np.asarray(w))
        n = max(int(nv[b]) - T1, 0)
        for k, w in jr.items():
            assert np.array_equal(got[k][b, :n].numpy(),
                                  np.asarray(w)[:n]), (k, b)


@pytest.mark.parametrize("frame0", ["none", "committed"])
@pytest.mark.parametrize("net", NETS)
def test_traceback_matches_jax(nets, net, frame0):
    """The walk over the same records: ok, the sink edge and value, the
    crossed closure edges and their entry values, on rows that reach the
    terminal sink and rows that do not (no valid frame, one frame)."""
    jd, td = nets[net]
    B, T = 6, 48
    obs = _obs(td, B, T, seed=11)
    nv = np.asarray([T, T - 9, 1, 0, 30, T], np.int32)
    recs = td._scan_batch(torch.from_numpy(obs), torch.from_numpy(nv))
    jrecs = {k: jnp.asarray(v.numpy()) for k, v in recs.items()}
    if frame0 == "none":
        f0 = None
        want = jd._traceback_batch(jrecs, jnp.asarray(nv))
    else:
        f0 = np.asarray([5, 0, -1, 3, 29, T - 2], np.int32)
        want = jd._traceback_batch(jrecs, jnp.asarray(nv), jnp.asarray(f0))
    got = td._traceback_batch(recs, torch.from_numpy(nv),
                              None if f0 is None else torch.from_numpy(f0))
    names = ("ok", "sink_edge", "sink_val", "edges", "vals")
    for name, g, w in zip(names, got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, name
        assert np.array_equal(g, w.astype(g.dtype)), name
    ok = np.asarray(want[0])
    assert not ok[3] and ok.any()
    if frame0 == "none":
        assert (np.asarray(want[3]) >= 0).sum() > 0


def test_traceback_plain_wrapper_equal():
    """The wrapper on CPU tensors is the plain walk (no launch counted)."""
    td = tst.NetworkDecoder(synth.random_network(6, seed=5))
    obs = torch.from_numpy(_obs(td, 3, 20, seed=2))
    nv = torch.tensor([20, 7, 0], dtype=torch.int32)
    recs = td._scan_batch(obs, nv)
    tb = td.edge_tables("cpu")
    f0 = torch.tensor([-1, 2, -1], dtype=torch.int32)
    before = nettrace.LAUNCHES
    a = nettrace.nettrace(recs, nv, f0, tb, 0)
    b = nettrace.nettrace_plain(recs, nv, f0, tb, 0)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert nettrace.LAUNCHES == before


@pytest.mark.parametrize("frame0", ["none", "committed"])
@pytest.mark.parametrize("net", NETS)
def test_traceback_int16_records_match_jax(nets, net, frame0):
    """The walk over the same records with their ids cast to int16 (kernel
    H's int16 instance, as the decode server keeps them): JAX's walk over
    the int32 records."""
    jd, td = nets[net]
    B, T = 5, 40
    obs = _obs(td, B, T, seed=12)
    nv = np.asarray([T, 17, 1, 0, T - 3], np.int32)
    recs = td._scan_batch(torch.from_numpy(obs), torch.from_numpy(nv))
    jrecs = {k: jnp.asarray(v.numpy()) for k, v in recs.items()}
    f0 = None if frame0 == "none" else np.asarray([4, 0, -1, 2, 30],
                                                 np.int32)
    want = jd._traceback_batch(jrecs, jnp.asarray(nv),
                               None if f0 is None else jnp.asarray(f0))
    r16 = {k: (v.to(torch.int16) if v.dtype == torch.int32 else v)
           for k, v in recs.items()}
    got = td._traceback_batch(r16, torch.from_numpy(nv),
                              None if f0 is None else torch.from_numpy(f0))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(g.numpy()
                                                               .dtype))
    assert np.asarray(want[0]).any()


@pytest.mark.parametrize("net", NETS)
def test_network_tables_from_jax(nets, net):
    jd, td = nets[net]
    got = convert.network_tables_from_jax(jd)
    for f in FIELDS:
        a, b = getattr(got, f), getattr(td.tables, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (got.n_states, got.n_models, got.n_sinks) == \
        (td.tables.n_states, td.tables.n_models, td.tables.n_sinks)


def _first_max(vals, src, w, length=None):
    """[B, N] values, [D, K] sources and weights -> per row and
    destination the first maximum of vals[src] + w over the first
    ``length[d]`` slots, and its slot."""
    v = vals[:, src.long()] + w
    if length is not None:
        past = torch.arange(src.shape[1])[None] >= length[:, None]
        v = torch.where(past, torch.tensor(-float("inf")), v)
    k = torch.argmax(v, dim=2)
    return v.gather(2, k[..., None])[..., 0], k


def _read_tables(carry, obs, t0, n_valid, beam, tb):
    """The scan as the kernel reads ``slot_arrays``' tables: the in-model
    and exit slots, then each distinct closure / sink row reduced once
    and each destination's edge id and word-time source read at its
    row's winning slot."""
    alpha, wt, entry, entry_edge, entry_wt = carry
    B, T, E = obs.shape
    M, D = tb["ex_slot"].shape[0], tb["cx_of"].shape[0]
    neg = torch.full((B, 1), float(tst.NEG))
    ins, exs = tb["in_slot"], tb["ex_slot"]
    f32 = lambda a: a.contiguous().view(torch.float32)  # noqa: E731
    rows, dst, of = tb["cx_row"], tb["cx_dst"], tb["cx_of"].long()
    no_cs = tb["cs_w"].shape[0] == 0
    recs = {k: [] for k in netscan.RECORDS}
    for i in range(T):
        t = (t0 + 1 + i).to(torch.int32)
        best, k = _first_max(torch.cat([entry, alpha, neg], 1),
                             ins[..., 0], f32(ins[..., 3]))
        e_ar = torch.arange(E)[None]
        in_am, z = ins[e_ar, k, 1], ins[e_ar, k, 2].long()
        nwt = torch.cat([entry_wt, wt], 1).gather(1, z)
        na = best + obs[:, i]
        thresh = na.amax(1, keepdim=True) - beam[:, None]
        na = torch.where(na >= thresh, na, float(tst.NEG))
        xv, k = _first_max(torch.cat([na, neg], 1), exs[..., 0],
                           f32(exs[..., 3]))
        m_ar = torch.arange(M)[None]
        ex_am = exs[m_ar, k, 1]
        xwt = nwt.gather(1, exs[m_ar, k, 2].long())
        uv, uk = _first_max(torch.cat([xv, neg], 1), rows[..., 0],
                            f32(rows[..., 1]), tb["cx_len"])
        v, k = uv[:, of], uk[:, of]
        d_ar = torch.arange(D)[None]
        ids, z = dst[d_ar, k, 0], dst[d_ar, k, 1].long()
        zwt = xwt.gather(1, z.clamp(min=0))
        ne = torch.where(v[:, :M] >= thresh, v[:, :M], float(tst.NEG))
        new_wt = torch.where(z[:, :M] < 0, t[:, None], zwt[:, :M])
        sv, cs_am, sw = v[:, M:], ids[:, M:], zwt[:, M:]
        if no_cs:
            sv = torch.full_like(sv, float(tst.NEG))
            cs_am, sw = torch.zeros_like(cs_am), torch.zeros_like(sw)
        for name, x in (("in_am", in_am), ("ex_am", ex_am),
                        ("cm_am", ids[:, :M]), ("entry_edge", entry_edge),
                        ("entry_val", entry), ("sink_val", sv),
                        ("cs_am", cs_am), ("sink_wt", sw),
                        ("exit_val", xv)):
            recs[name].append(x)
        valid = (t <= n_valid)[:, None]
        new = (na, nwt, ne, ids[:, :M].clamp(min=0), new_wt)
        alpha, wt, entry, entry_edge, entry_wt = (
            torch.where(valid, n_, o_) for n_, o_ in zip(
                new, (alpha, wt, entry, entry_edge, entry_wt)))
    return (alpha, wt, entry, entry_edge, entry_wt), {
        k: torch.stack(v, 1).to(netscan.RECORDS[k][0])
        for k, v in recs.items()}


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


READING_CASES = {
    # name: (B, T, beam per row or None, ties)
    "ragged_off_beam": (5, 40, None, False),
    "ties_signed_zeros": (4, 30, None, True),
    "tight_beam_by_row": (4, 30, (1.5, 3.0, 0.5, 6.0), True),
}


@pytest.mark.parametrize("case", list(READING_CASES))
@pytest.mark.parametrize("net", NETS + ("en_kws",))
def test_distinct_rows_match_plain_and_jax(nets, en_kws, net, case):
    """Kernel G's tables read as the kernel reads them (each distinct
    closure / sink row once, each destination's id and word-time source
    at the winning slot) equal netscan_plain in the carry and all nine
    records bit for bit, and JAX's scan_block row by row on valid
    frames."""
    jd, td = en_kws if net == "en_kws" else nets[net]
    B, T, beam, ties = READING_CASES[case]
    obs = _obs(td, B, T, seed=len(net) + len(case), ties=ties)
    nv = np.asarray([T, T - 7, 1, 0, T // 2][:B], np.int32)
    bm = np.full(B, jst.OFF_BEAM, np.float32) if beam is None else \
        np.asarray(beam, np.float32)
    args = (td.init_carry("cpu", B), torch.from_numpy(obs),
            torch.zeros(B, dtype=torch.int32), torch.from_numpy(nv),
            torch.from_numpy(bm), td.edge_tables("cpu"))
    got = _read_tables(*args)
    want = netscan.netscan_plain(*args)
    for g, w in zip(got[0], want[0]):
        assert torch.equal(_bits(g), _bits(w))
    for k in netscan.RECORDS:
        assert torch.equal(_bits(got[1][k]), _bits(want[1][k])), k
    for b in range(B):
        jc, jr = jd.scan_block(jd.init_carry(), jnp.asarray(obs[b]), 0,
                               jnp.int32(nv[b]), jnp.float32(bm[b]))
        for g, w in zip(got[0], jc):
            assert np.array_equal(g[b].numpy(), np.asarray(w))
        n = int(nv[b])
        for k, w in jr.items():
            assert np.array_equal(got[1][k][b, :n].numpy(),
                                  np.asarray(w)[:n]), (k, b)


@pytest.mark.parametrize("net", NETS + ("en_kws",))
def test_distinct_rows_group_equal_sequences(nets, en_kws, net):
    """Each destination's row in ``cx_row`` is its own closure / sink row
    (sources and weight bits, length included), distinct rows differ,
    and its ids and word-time sources are its own slots'."""
    td = (en_kws if net == "en_kws" else nets[net])[1]
    t = td.tables
    tb = netscan.slot_arrays(t)
    U = tb["cx_row"].shape[0]
    keys = {(int(tb["cx_len"][u]),
             tb["cx_row"][u, :tb["cx_len"][u]].tobytes()) for u in range(U)}
    assert len(keys) == U
    for d in range(t.n_models + t.n_sinks):
        dense = t.cm_dense[d] if d < t.n_models else \
            t.cs_dense[d - t.n_models]
        u = tb["cx_of"][d]
        assert tb["cx_len"][u] == len(dense)
        assert np.array_equal(tb["cx_dst"][d, :len(dense), 0], dense)
    if net == "cz_loop":
        assert U == 2          # the 46 entries' row and the sink's
    if net == "repeated_rows":
        assert U < t.n_models + t.n_sinks


@pytest.mark.parametrize("net", NETS + ("en_kws", "random_big"))
def test_instance_plan(nets, en_kws, net):
    """Kernel G's instance by the network's sizes alone: a warp a row for
    the phoneme loops, the KWS nets and the small word networks; the
    block design for the 1,500-model random network (past every warp
    limit of models, destinations and distinct rows)."""
    if net == "random_big":
        td = tst.NetworkDecoder(synth.random_network(1500, seed=1))
    else:
        td = (en_kws if net == "en_kws" else nets[net])[1]
    tb = td.edge_tables("cpu")
    want = "block" if net == "random_big" else "warp"
    assert netscan.plan_instance(tb) == want
    if net == "random_big":
        z = netscan._sizes(tb)
        assert z["M"] > netscan.WARP_MAX_M and z["U"] > netscan.WARP_MAX_U
