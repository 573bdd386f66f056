"""The port's mel frontend, norms and on-device waveform conversion against
phnrec_tpu on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phnrec_tpu import normalization as jnorm
from phnrec_tpu.frontend import melbanks as jmel
from phnrec_tpu.io import audio as jaudio

from phnrec_tpu_torch import normalization as tnorm
from phnrec_tpu_torch import synth
from phnrec_tpu_torch.convert import frontend_from_matrices
from phnrec_tpu_torch.frontend import melbanks as tmel
from phnrec_tpu_torch.pipeline import SpeechRec

SPECS = [dict(),                                           # the CZ frontend
         dict(preem_coef=0.97, z_mean=True, nbanks=23, nbanks_full=24,
              lo_freq=0.0)]


def _waves(seed, n_rows=3, n=16000):
    rng = np.random.default_rng(seed)
    return np.stack([synth.synth_audio(rng, n).astype(np.float32)
                     for _ in range(n_rows)])


@pytest.mark.parametrize("kw", SPECS)
def test_log_mel_matches(kw):
    jfe = jmel.MelFrontend(jmel.MelSpec(**kw))
    tfe = tmel.MelFrontend(tmel.MelSpec(**kw))
    # the matrices are built by the same float64 numpy code
    assert np.array_equal(np.asarray(jfe.dft), tfe.dft.numpy())
    assert np.array_equal(np.asarray(jfe.mel), tfe.mel.numpy())
    waves = _waves(0)
    T = jfe.frame_count(waves.shape[1])
    want = np.asarray(jax.vmap(lambda w: jfe(w, T))(jnp.asarray(waves)))
    got = tfe(torch.from_numpy(waves), T).numpy()
    # two float32 GEMMs summed in another order: measured max relative
    # error 1.2e-7 (1 ulp) on log energies of 7..27
    np.testing.assert_allclose(got, want, rtol=5e-7, atol=0)


def test_frontend_from_matrices():
    jfe = jmel.MelFrontend(jmel.MelSpec())
    fe = frontend_from_matrices(jfe.spec, jfe.dft, jfe.mel)
    ref = tmel.MelFrontend(tmel.MelSpec())
    assert fe.spec == ref.spec
    assert torch.equal(fe.dft, ref.dft) and torch.equal(fe.mel, ref.mel)


@pytest.mark.parametrize("L,T", [(150, 1), (150, 3), (199, 2), (200, 1)])
def test_short_wave_frames_clamp(L, T):
    """A wave shorter than the frames need: JAX's gather clamps indices
    past the end to the last sample, and so does the port."""
    wave = synth.synth_audio(np.random.default_rng(L), L).astype(np.float32)
    jfe = jmel.MelFrontend(jmel.MelSpec())
    tfe = tmel.MelFrontend(tmel.MelSpec())
    want = np.asarray(jfe.frames_from_wave(jnp.asarray(wave), T))
    got = tfe.frames_from_wave(torch.from_numpy(wave), T).numpy()
    assert np.array_equal(got, want)
    np.testing.assert_allclose(
        tfe(torch.from_numpy(wave), T).numpy(),
        np.asarray(jfe(jnp.asarray(wave), T)), rtol=5e-7, atol=0)


@pytest.mark.parametrize("shift,floor", [(0.0, jnorm.FRAME_NORM_NO_FLOOR),
                                         (1.5, 9.0)])
def test_frame_norm(shift, floor):
    x = np.random.default_rng(1).standard_normal((4, 9)).astype(np.float32) \
        * 4 + 10
    want = np.asarray(jnorm.frame_norm(jnp.asarray(x), shift, floor))
    got = tnorm.frame_norm(torch.from_numpy(x), shift, floor).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("spec", [
    dict(mean_norm=True), dict(var_norm=True),
    dict(mean_norm=True, var_norm=True), dict(max_norm=True),
    dict(chmax_norm=True), dict()])
def test_sentence_norm_ragged(spec):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 50, 15)) * 3 + 10).astype(np.float32)
    n_valid = np.array([50, 17, 1], np.int32)
    js = jnorm.SentenceNormSpec(**spec)
    want = np.asarray(jax.vmap(
        lambda p, n: jnorm.sentence_norm(p, js, n_valid=n))(
        jnp.asarray(x), jnp.asarray(n_valid)))
    got = tnorm.sentence_norm(x=torch.from_numpy(x),
                              spec=tnorm.SentenceNormSpec(**spec),
                              n_valid=torch.from_numpy(n_valid)).numpy()
    # masked sums over <= 50 rows in another order: measured max 1.9e-6
    # on values of ~10 (2 ulp)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # unmasked form on one utterance
    want1 = np.asarray(jnorm.sentence_norm(jnp.asarray(x[0]), js))
    got1 = tnorm.sentence_norm(torch.from_numpy(x[0]),
                               tnorm.SentenceNormSpec(**spec)).numpy()
    np.testing.assert_allclose(got1, want1, rtol=0, atol=1e-5)


@pytest.fixture(scope="module", params=["lin16", "alaw"])
def fmt_pkg(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"fe_{request.param}")
    return request.param, synth.write_lcrc_package(root, "tiny", seed=2,
                                                   fmt=request.param)


@pytest.mark.parametrize("dc_scale", [(0.0, 1.0), (3.25, 0.5)])
def test_device_wave_conversion(fmt_pkg, dc_scale):
    """BatchPipeline.convert_wave (the on-device lin16 / A-law decode of
    phnrec_tpu/parallel/batch.py:93-121) gives the host conversion's floats
    exactly, with zeros past each row's true length."""
    fmt, pkg = fmt_pkg
    sr = SpeechRec(pkg, device="cpu")
    sr.wave_dc_shift, sr.wave_scale = dc_scale
    bp = sr.batch_pipeline
    rng = np.random.default_rng(3)
    lens = [1000, 333, 150]
    L = 1024
    if fmt == "lin16":
        rows = [rng.integers(-32768, 32767, n).astype("<i2") for n in lens]
        wave = np.zeros((3, L), np.int16)
    else:
        rows = [rng.integers(0, 256, n).astype(np.uint8) for n in lens]
        wave = np.full((3, L), 0x55, np.uint8)   # any pad code: it is masked
    for i, r in enumerate(rows):
        wave[i, : len(r)] = r
    got = bp.convert_wave(torch.from_numpy(wave),
                          torch.tensor(lens, dtype=torch.int32)).numpy()
    for i, r in enumerate(rows):
        want, n = jaudio.convert_waveform(r.tobytes(), fmt)
        want = want[:n]
        if dc_scale[0]:
            want = (want + np.float32(dc_scale[0])) * np.float32(dc_scale[1])
            want = np.concatenate([want, np.full(L - n, np.float32(
                dc_scale[0]) * np.float32(dc_scale[1]), np.float32)])
        else:
            want = np.concatenate([want, np.zeros(L - n, np.float32)])
        assert np.array_equal(got[i], want), i


@pytest.mark.parametrize("value", ["none 0 0 0", "log 0 0 0",
                                   "igor 0.3 10 20", "gmm_bypass 0 0 0"])
def test_softening_matches(value):
    from phnrec_tpu import softening as jsoft
    from phnrec_tpu_torch import softening as tsoft
    assert tuple(tsoft.parse_softening(value)) == \
        tuple(jsoft.parse_softening(value))
    v = np.random.default_rng(5).uniform(1e-6, 1 - 1e-6, 1000) \
        .astype(np.float32)
    want = np.asarray(jsoft.softening_fn(jsoft.parse_softening(value))(
        jnp.asarray(v)))
    got = tsoft.softening_fn(tsoft.parse_softening(value))(
        torch.from_numpy(v)).numpy()
    # float32 log, sqrt and divisions: measured max 2.4e-7 absolute,
    # 1.8e-7 relative (1-2 ulp) on values up to 13
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        tsoft.parse_softening("cube 0 0 0")
