"""The 3BT / 1BT / 1BT_DCT posterior systems and the PLP frontend: the
port (CPU: the plain versions of kernels A and A′, band by band) against
phnrec_tpu on the same inputs.

* ``clamped_context`` bit-equal (copies only), batched over utterances
  against phnrec_tpu's vmapped form, ragged valid counts included.
* ``TrapsEstimator`` (3BT, 1BT; with and without the Hamming window) and
  ``DCTEstimator`` (with and without C0) on seeded nets and ragged
  params: within TOL_POST of phnrec_tpu's posteriors (two MLPs, an ln and
  a DCT or the windowed trajectories in float32: measured up to 1.3e-7
  at these sizes).
* ``PLPFrontend`` within TOL_PLP of phnrec_tpu's on seeded audio (the
  cube-root power and Durbin's divisions round differently: measured up
  to 3.1e-5 on cepstra of magnitude ~25-70).
* End to end: ``SpeechRec`` on synthetic 3BT, 1BT, 1BT_DCT and PLP (LCRC)
  packages through ``process_file_list``; streaming and multi-stream
  serving on a 3BT and a 1BT_DCT package: labels equal in names and
  boundaries, scores within TOL_SCORE (log-posteriors differ by a few
  1e-5, as for the LCRC package).
* The serving posterior block of each traps system (what the streaming
  recognizer and the multi-stream servers call) within TOL_LP of
  phnrec_tpu's; MultiStreamStkDecode on a 1BT stkint package gives its
  labels.
* The band stack's plain version equals per-band calls of the single
  net's plain version, for kernel A and A′ at both pass counts, and the
  converters carry phnrec_tpu's objects into equal port objects."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phnrec_tpu.frontend.melbanks import MelSpec as JMelSpec
from phnrec_tpu.frontend.plp import PLPFrontend as JPLP
from phnrec_tpu.io.weights import MLPParams as JMLPParams
from phnrec_tpu.multistream import MultiStreamRecognizer as JMS
from phnrec_tpu.pipeline import SpeechRec as JSpeechRec
from phnrec_tpu.posteriors import estimator as jest
from phnrec_tpu.posteriors.stc import clamped_context as jclamped
from phnrec_tpu.streaming import StreamingRecognizer as JSR

from phnrec_tpu_torch import convert, precision, synth
from phnrec_tpu_torch.frontend.melbanks import MelSpec
from phnrec_tpu_torch.frontend.plp import PLPFrontend
from phnrec_tpu_torch.io.labels import read_mlf
from phnrec_tpu_torch.io.weights import MLPParams
from phnrec_tpu_torch.multistream import MultiStreamRecognizer
from phnrec_tpu_torch.ops import mlp_bf16x3, mlp_fused
from phnrec_tpu_torch.pipeline import SpeechRec
from phnrec_tpu_torch.posteriors import estimator as test_
from phnrec_tpu_torch.posteriors.mlp import MLP
from phnrec_tpu_torch.posteriors.stc import clamped_context
from phnrec_tpu_torch.streaming import StreamingRecognizer

TRAP_LEN = 31
NB, HID, OUT = 5, 16, 7
TOL_POST = 5e-6
TOL_PLP = 2e-4
# log-posteriors after both softenings (ln amplifies small posteriors'
# relative error): measured up to 1.5e-5 at magnitudes up to 19
TOL_LP = 1e-4
TOL_SCORE = 2e-3


def _net(seed, n_inp, n_hid, n_out):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n_hid, n_inp)).astype(np.float32) * 0.3,
            rng.standard_normal(n_hid).astype(np.float32) * 0.1,
            rng.standard_normal((n_out, n_hid)).astype(np.float32) * 0.3,
            rng.standard_normal(n_out).astype(np.float32) * 0.1,
            rng.standard_normal(n_inp).astype(np.float32) * 0.3,
            rng.random(n_inp).astype(np.float32) + 0.5)


def _nets(cls, seeds, n_inp, n_out=OUT):
    return [cls(*_net(s, n_inp, HID, n_out)) for s in seeds]


def _params(seed, B=3, T=40):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, NB)).astype(np.float32),
            np.array([T, 17, 2], np.int32)[:B])


@pytest.mark.parametrize("trap_len,T", [(31, 40), (9, 5), (31, 1)])
def test_clamped_context_bit_equal(trap_len, T):
    rng = np.random.default_rng(T)
    p = rng.standard_normal((3, T, NB)).astype(np.float32)
    nv = np.array([T, max(T - 3, 0), 0], np.int32)
    want = jax.vmap(lambda x, n: jclamped(x, trap_len, n_valid=n))(
        jnp.asarray(p), jnp.asarray(nv))
    got = clamped_context(torch.from_numpy(p), trap_len,
                          torch.from_numpy(nv))
    assert got.shape == (3, T, trap_len, NB)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        clamped_context(torch.from_numpy(p[0]), trap_len).numpy(),
        np.asarray(jclamped(jnp.asarray(p[0]), trap_len)))
    np.testing.assert_array_equal(
        clamped_context(torch.from_numpy(p[1]), trap_len, 1).numpy(),
        np.asarray(jclamped(jnp.asarray(p[1]), trap_len, n_valid=1)))


def test_hamming_window_equal():
    for n in (9, 31):
        np.testing.assert_array_equal(test_.hamming_window(n),
                                      jest.hamming_window(n))


@pytest.mark.parametrize("system,use_hamming,fast_exp", [
    ("1BT", True, True), ("1BT", False, False), ("3BT", True, True),
    ("3BT", True, False)])
def test_traps_estimator_matches_jax(system, use_hamming, fast_exp):
    n_bands = NB - 2 if system == "3BT" else NB
    seeds = range(10, 10 + n_bands)
    kw = dict(nbanks=NB, system=system, trap_len=TRAP_LEN,
              use_hamming=use_hamming, fast_exp=fast_exp)
    je = jest.TrapsEstimator(
        "", band_nets=_nets(JMLPParams, seeds, TRAP_LEN),
        merger=_nets(JMLPParams, [99], n_bands * OUT, 9)[0], **kw)
    te = test_.TrapsEstimator(
        "", band_nets=_nets(MLPParams, seeds, TRAP_LEN),
        merger=_nets(MLPParams, [99], n_bands * OUT, 9)[0], **kw)
    assert te.bands.n_bands == te.trap_bands == n_bands
    p, nv = _params(1)
    want = np.asarray(je.posteriors_batched(jnp.asarray(p), jnp.asarray(nv)))
    marks = []
    got = te.posteriors_batched(torch.from_numpy(p), torch.from_numpy(nv),
                                mark=marks.append).numpy()
    assert got.shape == want.shape == (3, 40, 9)
    assert marks == ["context", "band_mlp", "merger_mlp"]
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_POST)
    # a single utterance through the streaming form of the merger input
    ctx = clamped_context(torch.from_numpy(p[0]), TRAP_LEN)
    np.testing.assert_allclose(
        te.merger(te.merger_input(ctx), fast_exp).numpy(),
        np.asarray(je.posteriors(jnp.asarray(p[0]))), rtol=0, atol=TOL_POST)
    # the converter gives the same estimator
    conv = convert.traps_from_jax(je)
    np.testing.assert_array_equal(
        conv.posteriors_batched(torch.from_numpy(p),
                                torch.from_numpy(nv)).numpy(), got)


@pytest.mark.parametrize("add_c0", [True, False])
def test_dct_estimator_matches_jax(add_c0):
    n_coefs = 6
    kw = dict(nbanks=NB, trap_len=TRAP_LEN, add_c0=add_c0, use_hamming=True)
    je = jest.DCTEstimator(
        "", merger=_nets(JMLPParams, [7], NB * n_coefs, 9)[0], **kw)
    te = test_.DCTEstimator(
        "", merger=_nets(MLPParams, [7], NB * n_coefs, 9)[0], **kw)
    p, nv = _params(2)
    want = np.asarray(je.posteriors_batched(jnp.asarray(p), jnp.asarray(nv)))
    got = te.posteriors_batched(torch.from_numpy(p),
                                torch.from_numpy(nv)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_POST)
    conv = convert.dct_from_jax(je)
    np.testing.assert_array_equal(
        conv.posteriors_batched(torch.from_numpy(p),
                                torch.from_numpy(nv)).numpy(), got)


def test_build_estimator_systems(tmp_path):
    """build_estimator's branches read the traps packages' files."""
    for system, cls in (("3BT", test_.TrapsEstimator),
                        ("1BT", test_.TrapsEstimator),
                        ("1BT_DCT", test_.DCTEstimator)):
        pkg = synth.write_traps_package(tmp_path / system, system, "tiny")
        est = test_.build_estimator(system, pkg, nbanks=5, add_c0=False)
        assert isinstance(est, cls) and est.trap_shift == 15
        assert est.merger.n_inp == {"3BT": 36, "1BT": 60, "1BT_DCT": 55}[
            system]


@pytest.mark.parametrize("passes", [0, 1, 3])
def test_band_stack_plain_equals_per_band_calls(passes):
    """The band stack's plain version (kernel A's or A′'s) is the single
    net's plain version band by band, bit for bit; on CPU tensors the
    wrappers run it and count no launch."""
    nets = _nets(MLPParams, range(20, 24), TRAP_LEN)
    stack = test_.BandStack([MLP.from_params(p) for p in nets])
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 50, TRAP_LEN)).astype(
        np.float32))
    before = (mlp_fused.LAUNCHES, mlp_bf16x3.LAUNCHES)
    mode = precision.get_mode()
    try:
        precision.set_mode({0: "highest", 1: "default", 3: "high"}[passes])
        got = stack(x)
        plain = stack(x, plain=True)
        want = torch.stack([MLP.from_params(p)(x[b], plain=True)
                            for b, p in enumerate(nets)])
    finally:
        precision.set_mode(mode)
    assert got.shape == (4, 50, OUT)
    assert torch.equal(got, want) and torch.equal(plain, want)
    assert (mlp_fused.LAUNCHES, mlp_bf16x3.LAUNCHES) == before


@pytest.mark.parametrize("nb,add_c0", [(12, False), (15, True)])
def test_plp_frontend_matches_jax(nb, add_c0):
    rng = np.random.default_rng(nb)
    w = synth.synth_audio(rng, 12000).astype(np.float32)
    args = (8000, 200, 80, nb, -1, 64.0, 4000.0)
    je, te = JPLP(JMelSpec(*args), add_c0=add_c0), \
        PLPFrontend(MelSpec(*args), add_c0=add_c0)
    assert te.n_params == je.n_params == 12 + add_c0
    n = te.frame_count(w.size)
    assert n == je.frame_count(w.size)
    want = np.asarray(je(jnp.asarray(w), n))
    got = te(torch.from_numpy(w), n).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_PLP)
    # batched over utterances, and carried across by the converter
    batch = te(torch.from_numpy(np.stack([w, w[::-1].copy()])), n)
    assert batch.shape == (2, n, te.n_params)
    np.testing.assert_array_equal(batch[0].numpy(), got)
    np.testing.assert_array_equal(
        convert.plp_from_jax(je)(torch.from_numpy(w), n).numpy(), got)


@pytest.fixture(scope="module")
def pkgs(tmp_path_factory):
    root = tmp_path_factory.mktemp("traps")
    out = {name: synth.write_traps_package(root / name, name, "tiny")
           for name in ("3BT", "1BT", "1BT_DCT")}
    out["PLP"] = synth.write_lcrc_package(root / "plp", "tiny", plp=True)
    for name in ("3BT", "1BT_DCT"):
        out[name + "_stream"] = synth.write_traps_package(
            root / (name + "_s"), name, "tiny", sent_norm=False)
    return out


def _key(labels):
    return [(l.start_frames, l.end_frames, l.name) for l in labels]


def _assert_same(got, want):
    assert want and _key(got) == _key(want)
    np.testing.assert_allclose([l.score for l in got],
                               [l.score for l in want], rtol=0,
                               atol=TOL_SCORE)


@pytest.mark.parametrize("name", ["3BT", "1BT", "1BT_DCT", "PLP"])
def test_speechrec_matches_jax(pkgs, name, tmp_path):
    """Four files of 0.4-3 s through both packages' process_file_list
    (the batch path: ragged rows, the LCRC or the traps estimator)."""
    rng = np.random.default_rng(6)
    lst = tmp_path / "list.scp"
    paths = []
    for i, n in enumerate((24000, 17003, 9001, 3000)):
        p = tmp_path / f"u{i}.raw"
        p.write_bytes(synth.synth_audio(rng, n).astype("<i2").tobytes())
        paths.append(str(p))
    lst.write_text("".join(p + "\n" for p in paths))
    sr, jsr = SpeechRec(pkgs[name], device="cpu"), JSpeechRec(pkgs[name])
    if name == "PLP":
        assert isinstance(sr.frontend, PLPFrontend)
    sr.process_file_list("wf", "str", str(lst), str(tmp_path / "t.mlf"))
    jsr.process_file_list("wf", "str", str(lst), str(tmp_path / "j.mlf"))
    got, want = read_mlf(str(tmp_path / "t.mlf")), \
        read_mlf(str(tmp_path / "j.mlf"))
    assert list(got) == list(want) and len(got) == 4
    for k in want:
        _assert_same(got[k], want[k])


@pytest.mark.parametrize("name", ["3BT", "1BT_DCT"])
def test_streaming_and_multistream_match_jax(pkgs, name):
    """A traps package streams (the traps branch of the posterior block)
    through StreamingRecognizer and MultiStreamRecognizer as in
    phnrec_tpu."""
    pkg = pkgs[name + "_stream"]
    sr, jsr = SpeechRec(pkg, device="cpu"), JSpeechRec(pkg)
    rng = np.random.default_rng(7)
    raws = [synth.synth_audio(rng, n).astype("<i2").tobytes()
            for n in (24000, 13001)]

    def run(rec):
        for i in range(0, len(raws[0]), 3001):
            rec.process(raws[0][i: i + 3001])
        return rec.finish()

    _assert_same(run(StreamingRecognizer(sr, block_frames=32)),
                 run(JSR(jsr, block_frames=32)))

    def serve(ms):
        for i, r in enumerate(raws):
            ms.process(i, r)
            ms.end_stream(i)
        return ms.finish()

    got = serve(MultiStreamRecognizer(sr, 2, block_frames=32))
    want = serve(JMS(jsr, 2, block_frames=32))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _assert_same(g, w)


@pytest.mark.parametrize("name", ["3BT", "1BT", "1BT_DCT"])
def test_posterior_block_fn_matches_jax(pkgs, name):
    """The serving posterior block (what StreamingRecognizer and the three
    multi-stream servers call) of a traps package, batched over streams,
    within TOL_LP of phnrec_tpu's vmapped block on the same contexts."""
    from phnrec_tpu.streaming import _make_posterior_block_fn as jblock
    from phnrec_tpu_torch.streaming import _make_posterior_block_fn
    sr, jsr = SpeechRec(pkgs[name], device="cpu"), JSpeechRec(pkgs[name])
    rng = np.random.default_rng(9)
    ctx = rng.standard_normal((3, 30 + 24, 5)).astype(np.float32)
    want = np.asarray(jax.vmap(jblock(jsr))(jnp.asarray(ctx)))
    got = _make_posterior_block_fn(sr)(torch.from_numpy(ctx)).numpy()
    assert got.shape == want.shape == (3, 24, 12)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_LP)


def test_multistream_stk_decode_on_1bt(tmp_path):
    """MultiStreamStkDecode takes a 1BT stkint decode package (the traps
    branch of its posterior block) and gives phnrec_tpu's labels."""
    from phnrec_tpu.multistream import MultiStreamStkDecode as JMSD
    from phnrec_tpu_torch.multistream import MultiStreamStkDecode
    pkg = synth.write_stk_decode_package(tmp_path / "p", "tiny",
                                         sent_norm=False, system="1BT")
    sr, jsr = SpeechRec(pkg, device="cpu"), JSpeechRec(pkg)
    rng = np.random.default_rng(8)
    raws = [synth.synth_audio(rng, n).astype("<i2").tobytes()
            for n in (20000, 11001)]

    def serve(ms):
        for i, r in enumerate(raws):
            ms.process(i, r)
            ms.end_stream(i)
        return ms.finish()

    got = serve(MultiStreamStkDecode(sr, 2, block_frames=32))
    want = serve(JMSD(jsr, 2, block_frames=32))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _assert_same(g, w)
