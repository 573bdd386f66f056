"""Kernels G and H's plain versions against phnrec_tpu on the same
numpy-seeded inputs: the edge-list scan's nine record arrays against
``NetworkDecoder._scan_batch`` / ``scan_block`` bit for bit on valid
frames (float values equal; +0.0 and -0.0 may differ where a max picks
between them), the traceback's outputs against ``_traceback_batch``
(frame0 = -1 and frame0 >= 0 rows, rows that never reach the terminal
sink), and ``convert.network_tables_from_jax`` against the port's own
compilation.  Networks: the tiny and CZ-width phoneme loops, the tiny KWS
net in decode mode and a random word network with isolated
destinations."""

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

NETS = ("tiny_loop", "cz_loop", "kws_decode", "random")
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
    return out


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
