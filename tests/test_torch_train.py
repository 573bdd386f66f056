"""HMM training in the port (train/: graphs, kernels K and K' by their
plain versions, accumulators, sMBR, the ML / MMI / MCE updates, the MMF
writer) against phnrec_tpu/train on the MMF_GMM and <PDFObsVec> sets of
tests/test_train.py, on the same seeded inputs.

Tolerances: the scans and log_obs sum in the same order as XLA on these
sizes (measured equal); the accumulators' einsums, xi product and
index_add_ sum in another order, measured max relative error 4.8e-6 (of
max(|x|, 1)); the updates are host numpy on those accumulators."""

import itertools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import phnrec_tpu.train as J
from phnrec_tpu.io.mmf import parse_mmf as jparse_mmf
from phnrec_tpu.io.mmf import write_mmf as jwrite_mmf
from phnrec_tpu.train import fb as jfb
from phnrec_tpu.train.graph import build_model_index as jindex
from tests.test_train import MMF_GMM

import phnrec_tpu_torch.train as P
from phnrec_tpu_torch.convert import accumulators_from_numpy
from phnrec_tpu_torch.io.mmf import parse_mmf, write_mmf
from phnrec_tpu_torch.train import fb as tfb
from phnrec_tpu_torch.train.graph import build_model_index

# accumulators against JAX's: relative to max(|x|, 1), measured 4.8e-6
REL_ACC = 2e-5
MMF_PDF = """~o <VecSize> 6 <PDFObsVec>
~h "p0"
<BeginHMM>
<NumStates> 3
<State> 2 <ObsCoef> 1
<TransP> 3
0.0 1.0 0.0
0.0 0.5 0.5
0.0 0.0 0.0
<EndHMM>
~h "p1"
<BeginHMM>
<NumStates> 3
<State> 2 <ObsCoef> 2
<TransP> 3
0.0 1.0 0.0
0.0 0.5 0.5
0.0 0.0 0.0
<EndHMM>
"""


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    d = tmp_path_factory.mktemp("mmf")
    out = {}
    for name, text in (("gmm", MMF_GMM), ("pdf", MMF_PDF)):
        p = d / f"{name}.mmf"
        p.write_text(text)
        out[name] = (jparse_mmf(str(p)), parse_mmf(str(p)))
    return out


def assert_acc_close(got, want, rel=REL_ACC):
    """Port accumulators (tensors) against JAX's, field by field."""
    for name in want._fields:
        a, b = getattr(want, name), getattr(got, name)
        if a is None:
            assert b is None, name
            continue
        a = np.asarray(a, np.float64)
        b = b.cpu().numpy().astype(np.float64)
        assert a.shape == b.shape, name
        err = np.abs(a - b) / np.maximum(np.abs(a), 1.0)
        assert err.max(initial=0) <= rel, (name, err.max())


def _lb(graph, x):
    return tfb.log_obs(tfb.make_obs_tables(graph, "cpu"), torch.tensor(x))


def test_graph_and_index_equal(sets):
    jm, tm = sets["gmm"]
    for trans in (["a", "b", "a"], ["b"], ["a", "b", "a", "b", "b"]):
        jg, tg = J.compile_transcription(jm, trans), \
            P.compile_transcription(tm, trans)
        for f in ("log_A", "log_entry", "log_exit", "state_model", "e_src",
                  "e_dst", "e_hmm", "e_row", "e_col", "en_state", "ex_state"):
            np.testing.assert_array_equal(getattr(tg, f), getattr(jg, f))
    ti, ji = build_model_index(tm), jindex(jm)
    for f in ("n_emitting", "state_hmm", "state_obs_coef", "gmm_weights",
              "gmm_means", "gmm_vars", "gmm_gconsts", "gmm_nmix"):
        np.testing.assert_array_equal(getattr(ti, f), getattr(ji, f))


@pytest.mark.parametrize("name", ["gmm", "pdf"])
def test_log_obs_matches_jax(sets, name):
    jm, tm = sets[name]
    trans = ["a", "b", "a"] if name == "gmm" else ["p0", "p1", "p0"]
    D = 2 if name == "gmm" else 6
    x = np.random.default_rng(0).normal(size=(11, D)).astype(np.float32)
    jb, jbm = jfb.log_obs(jfb.make_obs_tables(
        J.compile_transcription(jm, trans)), jnp.asarray(x))
    tb, tbm = _lb(P.compile_transcription(tm, trans), x)
    # two float32 GEMMs summed in another order: measured 2.4e-7
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6,
                               atol=1e-6)
    if jbm is None:
        assert tbm is None
    else:
        np.testing.assert_allclose(tbm.numpy(), np.asarray(jbm), rtol=1e-6,
                                   atol=1e-6)


def _brute(graph, log_b, combine):
    T, S = log_b.shape
    best = -np.inf
    for path in itertools.product(range(S), repeat=T):
        sc = graph.log_entry[path[0]] + log_b[0, path[0]]
        for t in range(1, T):
            sc += graph.log_A[path[t - 1], path[t]] + log_b[t, path[t]]
        sc += graph.log_exit[path[-1]]
        best = combine(best, sc)
    return best


def test_forward_backward_and_align_brute_force(sets):
    _, tm = sets["gmm"]
    g = P.compile_transcription(tm, ["a", "b"])
    x = np.random.default_rng(0).normal(size=(6, 2)).astype(np.float32)
    lb, _ = _lb(g, x)
    fb = P.forward_backward(g.log_A, g.log_entry, g.log_exit, lb, 6)
    ref = _brute(g, lb.double().numpy(), np.logaddexp)
    np.testing.assert_allclose(float(fb.log_like), ref, atol=1e-4)
    gamma = torch.exp(fb.log_alpha + fb.log_beta - fb.log_like)
    np.testing.assert_allclose(gamma.sum(1).numpy(), 1.0, atol=1e-4)
    al = P.viterbi_align(g.log_A, g.log_entry, g.log_exit, lb, 6)
    np.testing.assert_allclose(float(al.log_like),
                               _brute(g, lb.double().numpy(), max),
                               atol=1e-4)
    st = al.states.numpy()
    assert st[0] == 0 and st[-1] == 2 and np.all(np.diff(st) >= 0)


@pytest.mark.parametrize("n, T, pad", [(9, 9, 0), (13, 20, 5), (1, 4, 3),
                                       (12, 12, 7)])
def test_scans_match_jax(sets, n, T, pad):
    """forward_backward within tolerance (here equal) and viterbi_align
    equal, with ragged n_frames and padded graphs (the -1e30 / LOG_0 pad
    columns finite and equal, their ties settled to the smaller index)."""
    jm, tm = sets["gmm"]
    trans = ["a", "b", "a", "b"]
    jg, tg = J.compile_transcription(jm, trans), \
        P.compile_transcription(tm, trans)
    if pad:
        args = (jg.n_states + pad, len(jg.e_src) + 4, len(jg.en_state) + 2,
                len(jg.ex_state) + 2)
        jg, tg = J.graph.pad_graph(jg, *args), P.graph.pad_graph(tg, *args)
    x = np.random.default_rng(n + T).normal(size=(T, 2)).astype(np.float32)
    jlb = np.asarray(jfb.log_obs(jfb.make_obs_tables(jg), jnp.asarray(x))[0])
    lb = torch.tensor(jlb)
    jr = jfb.forward_backward(jg.log_A, jg.log_entry, jg.log_exit, jlb, n)
    r = P.forward_backward(tg.log_A, tg.log_entry, tg.log_exit, lb, n)
    for k in ("log_alpha", "log_beta", "log_like"):
        b = getattr(r, k).numpy()
        assert np.isfinite(b).all(), k
        np.testing.assert_allclose(b, np.asarray(getattr(jr, k)), rtol=1e-6,
                                   atol=1e-5, err_msg=k)
    ja = jfb.viterbi_align(jg.log_A, jg.log_entry, jg.log_exit, jlb, n)
    a = P.viterbi_align(tg.log_A, tg.log_entry, tg.log_exit, lb, n)
    np.testing.assert_array_equal(a.states.numpy(), np.asarray(ja.states))
    assert float(a.log_like) == float(ja.log_like)


def test_align_ties_take_the_smaller_state():
    """Uniform observations on a graph of equal transitions: every
    back-pointer ties, and K' keeps the smaller source as jnp.argmax."""
    S, T = 5, 7
    log_A = np.full((S, S), -1e10, np.float32)
    for i in range(S):
        log_A[i, i:] = np.log(0.5)
    entry = np.full(S, np.log(0.2), np.float32)
    exit_ = np.zeros(S, np.float32)
    lb = np.zeros((T, S), np.float32)
    ja = jfb.viterbi_align(log_A, entry, exit_, lb, T)
    a = P.viterbi_align(log_A, entry, exit_, torch.tensor(lb), T)
    np.testing.assert_array_equal(a.states.numpy(), np.asarray(ja.states))
    assert float(a.log_like) == float(ja.log_like)


def sample_data(rng, n_utts, T):
    xs = []
    for _ in range(n_utts):
        t1 = T // 2
        a = rng.normal(size=(t1, 2)) + np.array([0.5, 0.5])
        b = rng.normal(size=(T - t1, 2)) + np.array([-2.0, -2.0])
        xs.append(np.concatenate([a, b]).astype(np.float32))
    return xs


@pytest.mark.parametrize("mode", ["baum_welch", "viterbi"])
@pytest.mark.parametrize("name", ["gmm", "pdf"])
def test_accumulate_utterance_matches_jax(sets, mode, name):
    jm, tm = sets[name]
    rng = np.random.default_rng(5)
    if name == "gmm":
        utts = [(x, ["a", "b"]) for x in sample_data(rng, 3, 12)]
        utts.append((rng.normal(size=(9, 2)).astype(np.float32),
                     ["b", "a", "b"]))
    else:
        utts = []
        for T in (6, 9):
            lp = np.log(np.full((T, 6), 0.1, np.float32))
            lp[: T // 2, 0] = np.log(0.9)
            lp[T // 2:, 1] = np.log(0.9)
            utts.append((lp + rng.normal(size=lp.shape).astype(np.float32)
                         * 0.1, ["p0", "p1"]))
    ja = J.make_accumulators(jindex(jm))
    ta = P.make_accumulators(build_model_index(tm), "cpu")
    for i, (x, trans) in enumerate(utts):
        n = x.shape[0] - (i % 2)               # ragged: frames past n pad
        w = 1.0 + 0.5 * i
        ja = J.accumulate_utterance(J.compile_transcription(jm, trans), ja,
                                    x, n, weight=w, mode=mode)
        ta = P.accumulate_utterance(P.compile_transcription(tm, trans), ta,
                                    x, n, weight=w, mode=mode)
    assert_acc_close(ta, ja)


def test_accumulator_consistency(sets):
    _, tm = sets["gmm"]
    g = P.compile_transcription(tm, ["a", "b"])
    x = np.random.default_rng(5).normal(size=(10, 2)).astype(np.float32)
    acc = P.accumulate_utterance(g, P.make_accumulators(g.index, "cpu"), x,
                                 10)
    occ = acc.occ.numpy()
    assert np.isclose(occ.sum(), 10, atol=1e-3)
    assert float(acc.n_frames) == 10
    trans = acc.trans.numpy()
    assert trans[0, 0].sum() > 0.99
    assert np.isclose(trans[0, 1].sum(), occ[0].sum(), rtol=3e-3)
    a2 = P.accumulate_utterance(g, P.make_accumulators(g.index, "cpu"), x,
                                10, weight=2.0)
    np.testing.assert_allclose(a2.occ.numpy(), 2 * occ, atol=1e-4)
    m = P.merge_accumulators(acc, acc)
    np.testing.assert_allclose(m.occ.numpy(), 2 * occ, atol=1e-6)


def test_updates_match_jax(sets, tmp_path):
    """update_ml, update_mmi and apply_update on the port's accumulators
    (converted from JAX's, so both updates see the same numbers) equal
    JAX's, and write_mmf writes the same text."""
    jm, tm = sets["gmm"]
    ji, ti = jindex(jm), build_model_index(tm)
    jg = J.compile_transcription(jm, ["a", "b"])
    x = np.random.default_rng(7).normal(size=(10, 2)).astype(np.float32)
    num = J.accumulate_utterance(jg, J.make_accumulators(ji), x, 10)
    den = J.accumulate_utterance(jg, J.make_accumulators(ji), x, 10,
                                 weight=0.5)
    tnum, tden = accumulators_from_numpy(num), accumulators_from_numpy(den)
    jold = [jm.hmms[n].log_transp for n in ji.names]
    told = [tm.hmms[n].log_transp for n in ti.names]
    for ju, tu in ((J.update_ml(ji, num, jold), P.update_ml(ti, tnum, told)),
                   (J.update_mmi(ji, num, den, jold),
                    P.update_mmi(ti, tnum, tden, told))):
        for f in ("weights", "means", "variances", "occ"):
            np.testing.assert_array_equal(getattr(tu, f), getattr(ju, f))
        for a, b in zip(tu.log_transp, ju.log_transp):
            np.testing.assert_array_equal(a, b)
        jnew = J.apply_update(jm, ji, ju)
        tnew = P.apply_update(tm, ti, tu)
        jwrite_mmf(jnew, str(tmp_path / "j.mmf"))
        write_mmf(tnew, str(tmp_path / "t.mmf"))
        assert (tmp_path / "t.mmf").read_text() == \
            (tmp_path / "j.mmf").read_text()
    for tp, p in ((-100.0, -99.9), (-100.0, -99.999999), (-50.0, -50.0)):
        assert P.mce_weight(tp, p, 1.0) == J.mce_weight(tp, p, 1.0)
    assert P.mce_weight(-50.0, -50.0, 1.0) == 0.0


def test_baum_welch_ascends_and_matches_jax(sets):
    """Three Baum-Welch iterations on both packages: the log-likelihood
    never falls, and each iteration's equals JAX's."""
    jm, tm = sets["gmm"]
    xs = sample_data(np.random.default_rng(3), 4, 12)
    jl, tl = [], []
    for _ in range(3):
        ji, ti = jindex(jm), build_model_index(tm)
        ja, ta = J.make_accumulators(ji), P.make_accumulators(ti, "cpu")
        for x in xs:
            ja = J.accumulate_utterance(J.compile_transcription(
                jm, ["a", "b"], ji), ja, x, 12)
            ta = P.accumulate_utterance(P.compile_transcription(
                tm, ["a", "b"], ti), ta, x, 12)
        jl.append(float(ja.total_log_like))
        tl.append(float(ta.total_log_like))
        jm = J.apply_update(jm, ji, J.update_ml(
            ji, ja, [jm.hmms[n].log_transp for n in ji.names]))
        tm = P.apply_update(tm, ti, P.update_ml(
            ti, ta, [tm.hmms[n].log_transp for n in ti.names]))
    assert all(b >= a - 1e-3 for a, b in zip(tl, tl[1:])), tl
    np.testing.assert_allclose(tl, jl, rtol=1e-5)


def test_smbr_matches_jax(sets):
    jm, tm = sets["gmm"]
    jg, tg = J.compile_transcription(jm, ["a", "b"]), \
        P.compile_transcription(tm, ["a", "b"])
    x = np.random.default_rng(1).normal(size=(10, 2)).astype(np.float32)
    jlb = np.asarray(jfb.log_obs(jfb.make_obs_tables(jg), jnp.asarray(x))[0])
    al = P.viterbi_align(tg.log_A, tg.log_entry, tg.log_exit,
                         torch.tensor(jlb), 10)
    ref = P.reference_hmm_ids(tg, al.states)
    jal = jfb.viterbi_align(jg.log_A, jg.log_entry, jg.log_exit, jlb, 10)
    np.testing.assert_array_equal(ref, J.reference_hmm_ids(jg, jal.states))
    jn, jd = J.accumulate_utterance_mbr(
        jg, J.make_accumulators(jg.index), J.make_accumulators(jg.index), x,
        ref, 10)
    tn, td = P.accumulate_utterance_mbr(
        tg, P.make_accumulators(tg.index, "cpu"),
        P.make_accumulators(tg.index, "cpu"), x, ref, 10)
    assert_acc_close(tn, jn)
    assert_acc_close(td, jd)
    assert np.isclose(tn.occ.sum().item(), td.occ.sum().item(), atol=1e-3)
    upd = P.update_mmi(tg.index, tn, td, [tm.hmms[n].log_transp
                                          for n in tg.index.names], E=2.0)
    assert np.all(upd.variances > 0)


def test_save_load_and_psum(sets, tmp_path):
    _, tm = sets["gmm"]
    g = P.compile_transcription(tm, ["a", "b"])
    x = np.random.default_rng(0).normal(size=(8, 2)).astype(np.float32)
    acc = P.accumulate_utterance(g, P.make_accumulators(g.index, "cpu"), x,
                                 8)
    p = str(tmp_path / "acc.npz")
    P.save_accumulators(acc, p)
    back = P.load_accumulators(p, device="cpu")
    for a, b in zip(acc, back):
        assert (a is None and b is None) or torch.equal(a, b)
    # the same .npz layout as phnrec_tpu's
    jback = J.load_accumulators(p)
    assert_acc_close(back, jback, rel=0)
    assert float(P.merge_accumulators(back, back).n_frames) == 16.0
    from phnrec_tpu_torch.train.accum import psum_accumulators
    # an axis name is JAX's handle; the port takes a mesh or a group (its
    # all-reduce: tests/test_torch_distributed.py)
    with pytest.raises(TypeError, match="DeviceMesh"):
        psum_accumulators(acc, "data")
    assert P.psum_accumulators is psum_accumulators
    assert set(P.__all__) == set(J.__all__)


def test_pdfobsvec_alignment(sets):
    _, tm = sets["pdf"]
    g = P.compile_transcription(tm, ["p0", "p1"])
    T = 6
    lp = np.log(np.full((T, 6), 0.1, np.float32))
    lp[:3, 0] = np.log(0.9)
    lp[3:, 1] = np.log(0.9)
    lb, lbm = _lb(g, lp)
    assert lbm is None
    al = P.viterbi_align(g.log_A, g.log_entry, g.log_exit, lb, T)
    assert al.states.tolist() == [0, 0, 0, 1, 1, 1]
    acc = P.accumulate_utterance(g, P.make_accumulators(g.index, "cpu"), lp,
                                 T)
    assert np.isclose(float(acc.occ.sum()), T, atol=1e-3)
    assert acc.sum_x is None


def test_mmf_writer_roundtrip(sets, tmp_path):
    _, tm = sets["gmm"]
    p = str(tmp_path / "rt.mmf")
    write_mmf(tm, p)
    back = parse_mmf(p)
    for name in tm.hmms:
        a, b = tm.hmms[name], back.hmms[name]
        np.testing.assert_allclose(a.log_transp, b.log_transp, atol=1e-5)
        for ga, gb in zip(a.gmm_states, b.gmm_states):
            np.testing.assert_allclose(ga.means, gb.means, atol=1e-5)
            np.testing.assert_allclose(ga.variances, gb.variances, atol=1e-5)
    assert os.path.getsize(p) > 0
