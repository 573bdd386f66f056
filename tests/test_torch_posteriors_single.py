"""The single-utterance posterior API of the port against phnrec_tpu on
the CPU: ``posteriors`` of the LCRC, 3BT / 1BT and 1BT_DCT estimators,
``LCRCAssembler``'s call form (``forward``), ``context`` and
``context_indices``, ``MelFrontend.frame_indices`` and
``fexp_reference_np``.

* ``posteriors`` on synthetic ``"tiny"`` packages within the MLP tests'
  tolerance on probabilities (2e-6; these are not the merger widths);
* the port's single form equal bit for bit to its own batched row, at
  ``highest`` (kernel A's plain version) and ``high`` (A′'s), in a batch
  of its length; within 1e-6 in a ragged batch;
* the assembler's indices exactly, its features within 1e-6;
* the frame indices exactly, the fexp oracle exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phnrec_tpu.frontend import melbanks as jmel
from phnrec_tpu.posteriors import estimator as jest
from phnrec_tpu.posteriors import fexp as jfexp
from phnrec_tpu.posteriors.stc import LCRCAssembler as JAssembler
from phnrec_tpu.posteriors.stc import LCRCSpec as JSpec

from phnrec_tpu_torch import precision, synth
from phnrec_tpu_torch.config import PhnRecConfig
from phnrec_tpu_torch.frontend import melbanks as tmel
from phnrec_tpu_torch.posteriors import estimator as test_
from phnrec_tpu_torch.posteriors import fexp as tfexp
from phnrec_tpu_torch.posteriors.stc import LCRCAssembler, LCRCSpec

SYSTEMS = ("LCRC", "3BT", "1BT", "1BT_DCT")
# probabilities out of two float32 MLPs summed in another order
# (tests/test_torch_mlp.py)
TOL_POST = 2e-6
TOL_FEAT = 1e-6
LENGTHS = (40, 7, 1)


@pytest.fixture(scope="module")
def pkgs(tmp_path_factory):
    root = tmp_path_factory.mktemp("single")
    out = {"LCRC": synth.write_lcrc_package(root / "lcrc", "tiny", seed=3)}
    for system in SYSTEMS[1:]:
        out[system] = synth.write_traps_package(root / system, system,
                                                "tiny", seed=3)
    return out


def _estimators(pkg):
    """phnrec_tpu's and the port's (CPU) estimators of one package."""
    cfg = PhnRecConfig.load_package(pkg)
    kw = dict(nbanks=cfg.get_int("melbanks", "nbanks"),
              trap_len=cfg.get_int("posteriors", "length"),
              add_c0=cfg.get_bool("posteriors", "add_c0"),
              use_hamming=cfg.get_bool("posteriors", "hamming"))
    system = cfg.get_str("posteriors", "system")
    return (jest.build_estimator(system, pkg, **kw),
            test_.build_estimator(system, pkg, **kw).to("cpu"), kw["nbanks"])


def _params(seed, T, nb):
    return np.random.default_rng(seed).standard_normal((T, nb)).astype(
        np.float32)


@pytest.mark.parametrize("T", LENGTHS)
@pytest.mark.parametrize("system", SYSTEMS)
def test_posteriors_match_jax(pkgs, system, T):
    jst, tst, nb = _estimators(pkgs[system])
    params = _params(T, T, nb)
    want = np.asarray(jst.posteriors(jnp.asarray(params)))
    with torch.inference_mode():
        got = tst.posteriors(torch.from_numpy(params)).numpy()
    assert got.shape == want.shape == (T, tst.merger.n_out)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_POST)


@pytest.mark.parametrize("mode", ["highest", "high"])
@pytest.mark.parametrize("system", SYSTEMS)
def test_single_is_batched_row(pkgs, system, mode):
    """posteriors(params) equals its row of posteriors_batched bit for bit
    in a batch of utterances of its length, and within 1e-6 in a ragged
    padded batch (where the LCRC convolutions run at another length and
    sum in another order; phnrec_tpu's test_batched_matches_per_row holds
    its own pair to the same 1e-6)."""
    _, tst, nb = _estimators(pkgs[system])
    rng = np.random.default_rng(11)
    batch = rng.standard_normal((3, 40, nb)).astype(np.float32)
    precision.set_mode(mode)
    try:
        with torch.inference_mode():
            for n in ([40, 40, 40], [23, 40, 9]):
                rows = tst.posteriors_batched(torch.from_numpy(batch),
                                              torch.tensor(n))
                for b, k in enumerate(n):
                    one = tst.posteriors(torch.from_numpy(batch[b, :k]))
                    if k == 40:
                        assert torch.equal(one, rows[b]), (system, mode, b)
                    np.testing.assert_allclose(one.numpy(),
                                               rows[b, :k].numpy(), rtol=0,
                                               atol=1e-6)
    finally:
        precision.set_mode("highest")


def _assemblers(seed, nb=5, n_coefs=11):
    rng = np.random.default_rng(seed)
    wl = rng.random(16).astype(np.float32)
    wr = rng.random(16).astype(np.float32)
    j = JAssembler(JSpec(nbanks=nb, trap_len=31, n_coefs=n_coefs,
                         add_c0=True), wl, wr)
    t = LCRCAssembler(LCRCSpec(nbanks=nb, trap_len=31, n_coefs=n_coefs,
                               add_c0=True), wl, wr)
    return j, t


@pytest.mark.parametrize("T,n_valid", [(40, None), (40, 29), (12, 3),
                                       (1, None)])
def test_assembler_call_and_context(T, n_valid):
    j, t = _assemblers(T)
    params = _params(T + 100, T, 5)
    jn = None if n_valid is None else jnp.int32(n_valid)
    want_l, want_r = j(jnp.asarray(params), jn)
    with torch.inference_mode():
        got_l, got_r = t(torch.from_numpy(params), n_valid)
        ctx = t.context(torch.from_numpy(params), n_valid)
    for got, want in ((got_l, want_l), (got_r, want_r)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL_FEAT)
    # copies only: the context is equal exactly
    assert np.array_equal(ctx.numpy(), np.asarray(j.context(
        jnp.asarray(params), jn)))
    assert np.array_equal(t.context_indices(T).numpy(),
                          np.asarray(j.context_indices(T)))


@pytest.mark.parametrize("T", [1, 3, 97])
def test_frame_indices(T):
    jfe = jmel.MelFrontend(jmel.MelSpec())
    tfe = tmel.MelFrontend(tmel.MelSpec())
    assert np.array_equal(tfe.frame_indices(T).numpy(),
                          np.asarray(jfe.frame_indices(T)))
    # frames_from_wave takes the indices when the wave is too short
    wave = synth.synth_audio(np.random.default_rng(T), 150).astype(
        np.float32)
    want = np.asarray(jfe.frames_from_wave(jnp.asarray(wave), T))
    assert np.array_equal(
        tfe.frames_from_wave(torch.from_numpy(wave), T).numpy(), want)


def test_fexp_reference_np():
    y = np.concatenate([np.linspace(-90.0, 90.0, 4001),
                        np.random.default_rng(5).normal(0, 20, 2000)])
    assert np.array_equal(tfexp.fexp_reference_np(y),
                          jfexp.fexp_reference_np(y))
    assert np.array_equal(tfexp.fexp_reference_np(0.5),
                          jfexp.fexp_reference_np(0.5))
