"""The port's STK network stack against phnrec_tpu on the synthetic "tiny"
KWS package, which both packages load: the copied MMF/network/Xform
parsers and compile_network give the same arrays, OnlineNorm gives the
same blocks, state_observations and the DenseKWSScan.step loop match
(bit-equal: adds, maxes and first-index argmaxes), and the synthetic "en"
shape, write_kws_package and the DenseKWSScan table converter work."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phnrec_tpu import normalization as jnorm
from phnrec_tpu.decoder import stknet as jst
from phnrec_tpu.io import mmf as jmmf
from phnrec_tpu.io import stknet as jnet
from phnrec_tpu.io import xform as jxf
from phnrec_tpu.pipeline import SpeechRec as JSpeechRec

from phnrec_tpu_torch import convert, normalization, synth
from phnrec_tpu_torch.decoder import stknet as tst
from phnrec_tpu_torch.io import mmf as tmmf
from phnrec_tpu_torch.io import stknet as tnet
from phnrec_tpu_torch.io import xform as txf
from phnrec_tpu_torch.ops import netstep
from phnrec_tpu_torch.pipeline import SpeechRec


@pytest.fixture(scope="module")
def pkg(tmp_path_factory):
    return synth.write_kws_package(tmp_path_factory.mktemp("kws") / "pkg",
                                   "tiny", seed=0)


@pytest.fixture(scope="module")
def srs(pkg):
    return JSpeechRec(pkg), SpeechRec(pkg, device="cpu")


def _node_key(n):
    return (n.ident, n.order, n.ntype, n.word, n.model, n.pron_var,
            [(t.ident, w) for t, w in n.links])


def test_kws_package_loads_in_both(srs):
    jsr, sr = srs
    assert sr.stk_decoder.mode == jsr.stk_decoder.mode == "kws"
    assert sr.stk_decoder.keywords() == jsr.stk_decoder.keywords() == \
        ["alpha", "beta"]
    assert sr.stk_decoder.time_pruning == jsr.stk_decoder.time_pruning == 40
    # offline decoding runs (KWS mode: hits; none on flat input)
    flat = np.zeros((5, 12), np.float32)
    assert sr.stk_decoder.decode(flat) == jsr.stk_decoder.decode(flat)


def test_parsers_match(srs):
    jsr, sr = srs
    cfg = sr.cfg
    jm = jmmf.parse_mmf(cfg.get_str("models", "hmm_defs"))
    tm = tmmf.parse_mmf(cfg.get_str("models", "hmm_defs"))
    assert (tm.vec_size, tm.pdf_obs_vec) == (jm.vec_size, jm.pdf_obs_vec)
    assert list(tm.hmms) == list(jm.hmms)
    for name, h in tm.hmms.items():
        g = jm.hmms[name]
        assert (h.n_states, h.obs_coefs) == (g.n_states, g.obs_coefs)
        np.testing.assert_array_equal(h.log_transp, g.log_transp)
    path = cfg.get_str("networks", "default")
    jn, tn = jnet.parse_stk_network(path), tnet.parse_stk_network(path)
    assert [_node_key(n) for n in tn.nodes] == \
        [_node_key(n) for n in jn.nodes]


MMF_XFORM = """
~o <VecSize> 2 <PDFObsVec>
~x "lin" <Xform> 2 3 1 2 3 4 5 6
~x "b" <Bias> 2 0.5 -0.5
~j "inst" <VecSize> 2 ~x "lin"
<InputXform> <Input> ~j "inst" <VecSize> 2 ~x "b"
"""


def test_xform_parser_matches(tmp_path):
    p = tmp_path / "x.mmf"
    p.write_text(MMF_XFORM)
    jx, jj, jin = jxf.parse_mmf_xforms(str(p))
    tx, tj, tin = txf.parse_mmf_xforms(str(p))
    assert list(tx) == list(jx) and list(tj) == list(jj)
    np.testing.assert_array_equal(tx["lin"].matrix, jx["lin"].matrix)
    np.testing.assert_array_equal(tx["b"].vector, jx["b"].vector)
    assert (tin.name, tin.out_size, tin.input.name, tin.total_delay) == \
        (jin.name, jin.out_size, jin.input.name, jin.total_delay)


def test_compile_network_matches(srs):
    jsr, sr = srs
    jc, tc = jsr.stk_decoder.compiled, sr.stk_decoder.compiled
    for f in dataclasses.fields(jc):
        a, b = getattr(tc, f.name), getattr(jc, f.name)
        if f.name == "closure":
            assert [dataclasses.astuple(e) for e in a] == \
                [dataclasses.astuple(e) for e in b]
        elif isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert (tc.n_models, tc.n_states) == (9, 27)


@pytest.mark.parametrize("mean,var,interval", [(True, True, 10),
                                               (True, False, 7),
                                               (False, True, 0)])
def test_online_norm_matches(tmp_path, mean, var, interval):
    """OnlineNorm over blocks that straddle the estimation interval gives
    the same blocks as phnrec_tpu's (both host numpy: exact)."""
    rng = np.random.default_rng(3)
    j = jnorm.OnlineNorm(4, interval, mean, var)
    t = normalization.OnlineNorm(4, interval, mean, var)
    for n in (3, 5, 9, 1, 12):
        x = rng.normal(2.0, 3.0, (n, 4)).astype(np.float32)
        np.testing.assert_array_equal(t.process_block(x),
                                      j.process_block(x))


def _dense_pair(srs):
    jsr, sr = srs
    return (jst.DenseKWSScan(jsr.stk_decoder.decoder),
            tst.DenseKWSScan(sr.stk_decoder.decoder))


def test_dense_tables_and_converter(srs):
    jd, td = _dense_pair(srs)
    cd = convert.dense_kws_from_jax(jd)
    for d in (td, cd):
        for k in ("A_in", "A_ex", "A_cm", "R_cm", "A_cs", "_entry0"):
            np.testing.assert_array_equal(getattr(d, k),
                                          np.asarray(getattr(jd, k)), k)
        assert (d.M, d.E, d.n_sinks) == (jd.M, jd.E, jd.n_sinks)


@pytest.mark.parametrize("beam", [float(tst.OFF_BEAM), 8.0])
def test_dense_step_loop_bit_equal(srs, beam):
    """Port and JAX DenseKWSScan.step loops over 40 ragged frames: every
    output bit-equal, dead entries included."""
    jd, td = _dense_pair(srs)
    n, F = 6, 40
    rng = np.random.default_rng(7)
    obs = rng.normal(-3, 2, (F, n, td.E)).astype(np.float32)
    nv = np.array([40, 25, 0, 3, 40, 17], np.int32)
    nd = rng.integers(0, 100, n).astype(np.int32)
    bm = np.full(n, beam, np.float32)
    jc, tc = jd.init_carry(n), td.init_carry(n)
    for i in range(F):
        jc, (jsv, jsw) = jd.step(jc, jnp.asarray(obs[i]),
                                 jnp.asarray(nd + 1 + i),
                                 jnp.asarray(i < nv), jnp.asarray(bm))
        tc, (tsv, tsw) = td.step(tc, torch.from_numpy(obs[i]),
                                 torch.from_numpy(nd + 1 + i),
                                 torch.from_numpy(i < nv),
                                 torch.from_numpy(bm))
        np.testing.assert_array_equal(tsv.numpy(), np.asarray(jsv))
        np.testing.assert_array_equal(tsw.numpy(), np.asarray(jsw))
    for a, b in zip(tc, jc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_state_observations_pdf_and_gmm(srs):
    """PDFObsVec columns are gathered exactly; DiagC GMM states (two
    shapes, swapped into the tiny net's models) agree with JAX's batched
    log-likelihoods within 2e-5 relative (einsum and logsumexp sum in
    another order)."""
    jsr, sr = srs
    rng = np.random.default_rng(11)
    obs = rng.normal(0, 1, (2, 30, 12)).astype(np.float32)
    jd, td = jsr.stk_decoder.decoder, sr.stk_decoder.decoder
    np.testing.assert_array_equal(
        td.state_observations(torch.from_numpy(obs)).numpy(),
        np.stack([np.asarray(jd.state_observations(jnp.asarray(o)))
                  for o in obs]))

    def gmm_compiled(mod_mmf, mod_dec, dec):
        ms = mod_mmf.ModelSet(dec.model_set.vec_size, False, {})
        g = np.random.default_rng(5)
        for name, h in dec.model_set.hmms.items():
            gs = []
            for j in range(h.n_states - 2):
                m = 1 + (j % 2)
                gs.append(mod_mmf.GMMState(
                    weights=np.full(m, 1.0 / m, np.float32),
                    means=g.normal(0, 1, (m, 12)).astype(np.float32),
                    variances=g.uniform(0.5, 2, (m, 12)).astype(np.float32),
                    gconsts=g.uniform(10, 20, m).astype(np.float32)))
            ms.hmms[name] = mod_mmf.HmmDef(name, h.n_states,
                                           [None] * len(gs), gs,
                                           h.log_transp)
        return mod_dec.NetworkDecoder(mod_dec.compile_network(
            dec.network, ms, dec.wpenalty, dec.lm_scale))

    jg = gmm_compiled(jmmf, jst, jsr.stk_decoder)
    tg = gmm_compiled(tmmf, tst, sr.stk_decoder)
    want = np.stack([np.asarray(jg.state_observations(jnp.asarray(o)))
                     for o in obs])
    got = tg.state_observations(torch.from_numpy(obs)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-4)


def test_synth_en_shape_and_kws_package(tmp_path):
    """The "en" shape: 23 banks at 16 kHz, nets 253->500->120 and
    240->500->120, 40 phonemes with the keywords' phones, no sentence
    norm; its KWS package spots greasy/wash on a net that kernel B's
    structure gate accepts."""
    pkg = synth.write_kws_package(tmp_path / "en", "en", seed=0)
    sr = SpeechRec(pkg, device="cpu")
    spec = sr.frontend.spec
    assert (spec.sample_freq, spec.vector_size, spec.step, spec.nbanks) == \
        (16000, 400, 160, 23)
    assert not sr.sent_norm.enabled and sr.wpenalty == -2.03125
    shapes = [(n.n_inp, n.n_hid, n.n_out) for n in
              (*sr.estimator.band, sr.estimator.merger)]
    assert shapes == [(253, 500, 120)] * 2 + [(240, 500, 120)]
    assert len(sr.phonemes) == 40 and set("g r iy s w aa sh".split()) <= \
        set(sr.phonemes)
    assert sr.stk_decoder.keywords() == ["greasy", "wash"]
    c = sr.stk_decoder.compiled
    assert (c.n_models, c.n_states) == (48, 144)
    dense = tst.DenseKWSScan(sr.stk_decoder.decoder)
    assert netstep.extract_structure(dense)["S_M"] == 3
