"""STK binary accumulator files in the port (train/stk_accum.py): a round
trip, files written by phnrec_tpu read by the port and the other way round
(the same bytes from the same statistics), weighted reads, the
unknown-macro skip, and an update from a re-read file."""

import numpy as np
import pytest

import phnrec_tpu.train as J
from phnrec_tpu.io.mmf import parse_mmf as jparse_mmf
from phnrec_tpu.train.stk_accum import read_stk_accums as jread
from phnrec_tpu.train.stk_accum import write_stk_accums as jwrite
from tests.test_train import MMF_GMM
from tests.test_torch_train import assert_acc_close

import phnrec_tpu_torch.train as P
from phnrec_tpu_torch.convert import accumulators_from_numpy
from phnrec_tpu_torch.io.mmf import parse_mmf
from phnrec_tpu_torch.train.stk_accum import read_stk_accums, \
    write_stk_accums


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    p = tmp_path_factory.mktemp("mmf") / "models.mmf"
    p.write_text(MMF_GMM)
    jm, tm = jparse_mmf(str(p)), parse_mmf(str(p))
    g = J.compile_transcription(jm, ["a", "b"])
    rng = np.random.default_rng(0)
    acc = J.make_accumulators(g.index)
    for _ in range(3):
        T = int(rng.integers(6, 12))
        x = rng.normal(0, 1.5, (T, 2)).astype(np.float32)
        acc = J.accumulate_utterance(g, acc, x, T)
    tg = P.compile_transcription(tm, ["a", "b"])
    return jm, tm, g.index, tg.index, acc, accumulators_from_numpy(acc)


def test_roundtrip(tmp_path, setup):
    _, tm, _, ti, _, tacc = setup
    p = str(tmp_path / "a.acc")
    write_stk_accums(p, tm, ti, tacc)
    back, tot_frames, tot_ll = read_stk_accums(p, tm, ti, device="cpu")
    assert tot_frames == int(round(float(tacc.n_frames)))
    assert tot_ll == pytest.approx(float(tacc.total_log_like), rel=1e-6)
    for f, rtol in (("occ", 1e-5), ("sum_x", 1e-5), ("sum_xx", 1e-5),
                    ("trans", 1e-4)):
        np.testing.assert_allclose(getattr(back, f).numpy(),
                                   getattr(tacc, f).numpy(), rtol=rtol,
                                   atol=1e-5, err_msg=f)


def test_files_cross_read(tmp_path, setup):
    """Each package's file is the other's byte for byte, and each reads
    the other's into the same statistics."""
    jm, tm, ji, ti, jacc, tacc = setup
    pj, pt = str(tmp_path / "j.acc"), str(tmp_path / "t.acc")
    jwrite(pj, jm, ji, jacc)
    write_stk_accums(pt, tm, ti, tacc)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    for w in (1.0, 0.5):
        got, gf, gl = read_stk_accums(pj, tm, ti, weight=w, device="cpu")
        want, wf, wl = jread(pt, jm, ji, weight=w)
        assert (gf, gl) == (wf, wl)
        assert_acc_close(got, want, rel=0)


def test_update_from_file_equals_in_memory(tmp_path, setup):
    _, tm, _, ti, _, tacc = setup
    p = str(tmp_path / "a.acc")
    write_stk_accums(p, tm, ti, tacc)
    back, _, _ = read_stk_accums(p, tm, ti, device="cpu")
    old = [tm.hmms[n].log_transp for n in ti.names]
    u_mem, u_file = P.update_ml(ti, tacc, old), P.update_ml(ti, back, old)
    for f in ("weights", "means", "variances", "occ"):
        np.testing.assert_allclose(getattr(u_file, f), getattr(u_mem, f),
                                   rtol=1e-4, atol=1e-5, err_msg=f)
    for a, b in zip(u_mem.log_transp, u_file.log_transp):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)


def test_weight_scaling_and_unknown_macros(tmp_path, setup):
    _, tm, _, ti, _, tacc = setup
    p = str(tmp_path / "a.acc")
    write_stk_accums(p, tm, ti, tacc)
    half, _, _ = read_stk_accums(p, tm, ti, weight=0.5, device="cpu")
    full, _, _ = read_stk_accums(p, tm, ti, device="cpu")
    np.testing.assert_allclose(2.0 * half.occ.numpy(), full.occ.numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(2.0 * half.trans.numpy(),
                               full.trans.numpy(), rtol=1e-5)
    data = open(p, "rb").read()
    splice = b'~t "ghost"' + (0).to_bytes(4, "little") + b"\x00" * 8
    p2 = str(tmp_path / "b.acc")
    open(p2, "wb").write(data[:8] + splice + data[8:])
    back, _, _ = read_stk_accums(p2, tm, ti, device="cpu")
    np.testing.assert_allclose(back.occ.numpy(), full.occ.numpy(),
                               rtol=1e-6)
