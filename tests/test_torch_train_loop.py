"""The port's bucketed Reestimator against phnrec_tpu's (the same buckets,
keys and batch size) and against its own one-utterance path, in both
modes, on the MMF_GMM set and a <PDFObsVec> set; padded graphs contribute
nothing; kernels K / K' over a ragged bucket equal one utterance at a time.

Tolerances: the accumulators sum a bucket in another order than JAX's vmap
and than one utterance at a time: measured max relative error 4.7e-6 (of
max(|x|, 1)) against JAX."""

import numpy as np
import pytest
import torch

import phnrec_tpu.train as J
from phnrec_tpu.io.mmf import parse_mmf as jparse_mmf
from phnrec_tpu.train.graph import build_model_index as jindex
from phnrec_tpu.train.loop import Reestimator as JReestimator
from tests.test_train import MMF_GMM
from tests.test_torch_train import MMF_PDF, REL_ACC, assert_acc_close

import phnrec_tpu_torch.train as P
from phnrec_tpu_torch.io.mmf import parse_mmf
from phnrec_tpu_torch.ops import trainfb
from phnrec_tpu_torch.train.graph import build_model_index, pad_graph
from phnrec_tpu_torch.train.loop import Reestimator


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    d = tmp_path_factory.mktemp("loop")
    out = {}
    for name, text in (("gmm", MMF_GMM), ("pdf", MMF_PDF)):
        p = d / f"{name}.mmf"
        p.write_text(text)
        out[name] = (jparse_mmf(str(p)), parse_mmf(str(p)))
    return out


def _utts(name, n=7, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        T = 6 + 3 * i
        if name == "gmm":
            x = rng.normal(size=(T, 2)).astype(np.float32)
            trans = ["a", "b"] if i % 2 == 0 else ["b", "a", "b"]
        else:
            x = np.log(rng.dirichlet(np.ones(6), size=T)).astype(np.float32)
            trans = ["p0", "p1"] if i % 2 == 0 else ["p1", "p0", "p1"]
        out.append((x, trans, 1.0 + 0.25 * i))
    return out


def test_pad_graph_zero_influence(sets):
    _, tm = sets["gmm"]
    g = P.compile_transcription(tm, ["a", "b"])
    gp = pad_graph(g, g.n_states + 5, len(g.e_src) + 7,
                   len(g.en_state) + 3, len(g.ex_state) + 3)
    x = np.random.default_rng(0).normal(size=(9, 2)).astype(np.float32)
    a1 = P.accumulate_utterance(g, P.make_accumulators(g.index, "cpu"), x, 9)
    a2 = P.accumulate_utterance(gp, P.make_accumulators(g.index, "cpu"), x,
                                9)
    for f in ("occ", "trans", "total_log_like"):
        np.testing.assert_allclose(getattr(a2, f).numpy(),
                                   getattr(a1, f).numpy(), atol=1e-4)
    with pytest.raises(ValueError):
        pad_graph(g, g.n_states, len(g.e_src) + 1)


@pytest.mark.parametrize("mode", ["baum_welch", "viterbi"])
@pytest.mark.parametrize("name", ["gmm", "pdf"])
def test_reestimator_matches_jax(sets, name, mode):
    """Field by field against JAX's Reestimator on the same utterances,
    and against the port's own sequential path."""
    jm, tm = sets[name]
    utts = _utts(name)
    jr = JReestimator(jm, mode=mode, batch_size=3)
    tr = Reestimator(tm, mode=mode, batch_size=3, device="cpu")
    for x, trans, w in utts:
        jr.add_utterance(x, trans, w)
        tr.add_utterance(x, trans, w)
    want, got = jr.finish(), tr.finish()
    assert_acc_close(got, want)
    assert float(got.n_utts) == len(utts)
    np.testing.assert_allclose(tr.total_log_like, jr.total_log_like,
                               rtol=1e-6)
    ti = build_model_index(tm)
    seq = P.make_accumulators(ti, "cpu")
    for x, trans, w in utts:
        seq = P.accumulate_utterance(P.compile_transcription(tm, trans, ti),
                                     seq, x, x.shape[0], weight=w, mode=mode)
    for f in got._fields:
        a, b = getattr(seq, f), getattr(got, f)
        if a is not None:
            err = (a - b).abs() / a.abs().clamp(min=1.0)
            assert err.max().item() <= REL_ACC, f
    # the whole loop feeds the update path; the models round-trip
    upd = P.update_ml(ti, got, [tm.hmms[n].log_transp for n in ti.names])
    assert set(P.apply_update(tm, ti, upd).hmms) == set(tm.hmms)


@pytest.mark.parametrize("mode", ["baum_welch", "viterbi"])
def test_bucket_scan_equals_single(sets, mode):
    """Kernels K / K' (plain versions) over a padded, ragged bucket give
    each row what one utterance alone gives: K to float32 rounding of the
    batched lses, K' exactly."""
    _, tm = sets["gmm"]
    ti = build_model_index(tm)
    rng = np.random.default_rng(4)
    graphs = [P.compile_transcription(tm, t, ti)
              for t in (["a", "b"], ["b", "a", "b"], ["a"])]
    S = max(g.n_states for g in graphs) + 3
    padded = [pad_graph(g, S, 32, 4, 4) for g in graphs]
    T, ns = 14, [14, 9, 1]
    lb = torch.tensor(rng.normal(size=(3, T, S)).astype(np.float32) - 3)
    stack = [torch.tensor(np.stack([getattr(g, f) for g in padded]))
             for f in ("log_A", "log_entry", "log_exit")]
    n = torch.tensor(ns, dtype=torch.int32)
    fn = trainfb.graph_fb if mode == "baum_welch" else trainfb.graph_align
    out = fn(*stack, lb, n)
    for b in range(3):
        one = fn(*(s[b:b + 1] for s in stack), lb[b:b + 1], n[b:b + 1])
        for x, y in zip(out, one):
            if mode == "viterbi":
                assert torch.equal(x[b], y[0])
            else:
                np.testing.assert_allclose(x[b].numpy(), y[0].numpy(),
                                           rtol=1e-6)
    assert trainfb.LAUNCHES == 0 and trainfb.ALIGN_LAUNCHES == 0
