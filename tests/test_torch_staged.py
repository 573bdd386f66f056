"""The port's serial par/post staged I/O against phnrec_tpu on the tiny
LCRC and stkint packages: wf -> par, par -> post and post -> str on the same
inputs (features and posteriors within measured tolerances, labels equal),
the chain through HTK files against wf -> str, the CLI at every -s/-t pair,
``posteriors/enabled=false`` with -s post, the reference's error messages,
and which file lists run batched."""

import os

import numpy as np
import pytest

from phnrec_tpu import cli as jcli
from phnrec_tpu.pipeline import SpeechRec as JSpeechRec

from phnrec_tpu_torch import cli, synth
from phnrec_tpu_torch.io import htk
from phnrec_tpu_torch.io.labels import read_mlf
from phnrec_tpu_torch.pipeline import SpeechRec

LENGTHS = [24000, 17003, 9001, 150]       # ragged, one shorter than a frame
# log mel banks from the DFT-power and mel GEMMs in float32, summed in
# another order than XLA's: measured max 1.9e-6 on values up to ~25
TOL_PAR = 2e-5
# linear posteriors (softening "none") through the sentence norm, the LCRC
# convs and three float32 MLPs with fexp, as tests/test_torch_pipeline.py
# holds the log-posteriors: measured max 5.2e-6 on probabilities <= 1
# (3.3e-5 in their logs) over five utterances of 0.02-5 s
TOL_POST = 2e-5
# label scores are sums of log-posteriors over a segment: the posteriors
# above, or identical ones (post -> str)
TOL_SCORE = 1e-3
PAIRS = [("wf", "par"), ("wf", "post"), ("wf", "str"), ("par", "post"),
         ("par", "str"), ("post", "str")]


def _key(labels):
    return [(l.start_frames, l.end_frames, l.name) for l in labels]


def _no_traps(pkg):
    cfg = os.path.join(pkg, "config")
    text = open(cfg).read()
    assert "enabled=true" in text
    open(cfg, "w").write(text.replace("enabled=true", "enabled=false"))
    return pkg


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    root = tmp_path_factory.mktemp("staged")
    pkgs = {"lcrc": synth.write_lcrc_package(root / "lcrc", "tiny", seed=0),
            "stk": synth.write_stk_decode_package(root / "stk", "tiny",
                                                  seed=0)}
    rng = np.random.default_rng(3)
    wavs = []
    for i, n in enumerate(LENGTHS):
        p = root / f"u{i}.raw"
        p.write_bytes(synth.synth_audio(rng, n).astype("<i2").tobytes())
        wavs.append(str(p))
    srs = {k: SpeechRec(v, device="cpu") for k, v in pkgs.items()}
    jsrs = {k: JSpeechRec(v) for k, v in pkgs.items()}
    return dict(root=root, pkgs=pkgs, wavs=wavs, srs=srs, jsrs=jsrs)


@pytest.mark.parametrize("name", ["lcrc", "stk"])
def test_stages_match_jax(case, name):
    """Each stage on the same input as phnrec_tpu's: wf -> par from the
    same bytes, par -> post from JAX's par, post -> str from JAX's post."""
    sr, jsr = case["srs"][name], case["jsrs"][name]
    n_labels = 0
    for path in case["wavs"]:
        raw = open(path, "rb").read()
        jpar = np.asarray(jsr.params_from_waveform(raw))
        par = sr.params_from_waveform(raw)
        assert par.shape == jpar.shape and par.dtype == np.float32
        np.testing.assert_allclose(par, jpar, rtol=0, atol=TOL_PAR)
        jpost = np.asarray(jsr.posteriors_from_params(jpar))
        post = sr.posteriors_from_params(jpar)
        assert post.shape == jpost.shape
        np.testing.assert_allclose(post, jpost, rtol=0, atol=TOL_POST)
        want = jsr.decode_posteriors(jpost).labels
        got = sr.decode_posteriors(jpost).labels
        assert _key(got) == _key(want)
        np.testing.assert_allclose([l.score for l in got],
                                   [l.score for l in want], rtol=0,
                                   atol=TOL_SCORE)
        n_labels += len(want)
    assert n_labels > 10


@pytest.mark.parametrize("name", ["lcrc", "stk"])
def test_chain_through_htk_files_equals_wf_str(case, name, tmp_path):
    """wf -> par -> post -> str through HTK files gives wf -> str's labels
    (the chain re-reads float32 files, so the posteriors are the same
    numbers the batch of one computes, up to the sentence statistics'
    order)."""
    sr = case["srs"][name]
    for path in case["wavs"]:
        par_f, post_f = str(tmp_path / "u.mel"), str(tmp_path / "u.lop")
        sr.process_file("wf", "par", path, par_f)
        sr.process_file("par", "post", par_f, post_f)
        got = sr.process_file("post", "str", post_f).labels
        want = sr.process_offline("wf", "str", open(path, "rb").read()).labels
        assert _key(got) == _key(want)
        par, period, kind = htk.read_htk(par_f)
        assert (period, kind) == (htk.DEFAULT_SAMP_PERIOD,
                                  htk.DEFAULT_PARAM_KIND)
        assert par.shape[1] == sr.frontend.n_params


def _run_cli(main, pkg, inpf, outpf, sources, out_dir, mlf):
    """Both CLIs on one list: targets in ``out_dir`` (par/post), or an
    MLF (str)."""
    os.makedirs(out_dir, exist_ok=True)
    lst = os.path.join(out_dir, "list.scp")
    with open(lst, "w") as f:
        for s in sources:
            stem = os.path.splitext(os.path.basename(s))[0]
            f.write(f"{s} {os.path.join(out_dir, stem + '.' + outpf)}\n"
                    if outpf != "str" else f"{s}\n")
    argv = ["-c", pkg, "-s", inpf, "-t", outpf, "-l", lst]
    if outpf == "str":
        argv += ["-m", mlf]
    if main is cli.main:
        argv += ["--device", "cpu"]
    assert main(argv) == 0
    return lst


@pytest.mark.parametrize("name", ["lcrc", "stk"])
@pytest.mark.parametrize("inpf, outpf", PAIRS,
                         ids=[f"{a}-{b}" for a, b in PAIRS])
def test_cli_every_pair_matches_jax(case, name, inpf, outpf, tmp_path):
    """The CLI at each stage pair on the same inputs (staged inputs are
    JAX's files): HTK outputs within the stage tolerances, MLF labels
    equal."""
    pkg, wavs = case["pkgs"][name], case["wavs"]
    sources = wavs
    if inpf != "wf":
        stage_dir = str(tmp_path / "in")
        _run_cli(jcli.main, pkg, "wf", inpf, wavs, stage_dir, None)
        sources = [os.path.join(stage_dir, os.path.splitext(
            os.path.basename(w))[0] + "." + inpf) for w in wavs]
    mlf_j, mlf_t = str(tmp_path / "j.mlf"), str(tmp_path / "t.mlf")
    _run_cli(jcli.main, pkg, inpf, outpf, sources, str(tmp_path / "j"),
             mlf_j)
    _run_cli(cli.main, pkg, inpf, outpf, sources, str(tmp_path / "t"),
             mlf_t)
    if outpf == "str":
        want, got = read_mlf(mlf_j), read_mlf(mlf_t)
        assert list(got) == list(want) and len(got) == len(wavs)
        for k in want:
            assert _key(got[k]) == _key(want[k])
        return
    tol = TOL_PAR if outpf == "par" else TOL_POST
    for w in wavs:
        f = os.path.splitext(os.path.basename(w))[0] + "." + outpf
        a, pa, ka = htk.read_htk(str(tmp_path / "j" / f))
        b, pb, kb = htk.read_htk(str(tmp_path / "t" / f))
        assert (pa, ka) == (pb, kb) and a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=0, atol=tol)


def test_posteriors_disabled_decodes_post_files(case, tmp_path):
    """posteriors/enabled=false: -s post decodes files of posteriors as
    phnrec_tpu does; producing posteriors raises the reference's error."""
    pkg = _no_traps(synth.write_lcrc_package(tmp_path / "pkg", "tiny",
                                             seed=0))
    sr, jsr = SpeechRec(pkg, device="cpu"), JSpeechRec(pkg)
    assert sr.estimator is None and not sr.traps_enabled
    post_dir = str(tmp_path / "post")
    _run_cli(jcli.main, case["pkgs"]["lcrc"], "wf", "post", case["wavs"],
             post_dir, None)
    posts = [os.path.join(post_dir, f"u{i}.post")
             for i in range(len(case["wavs"]))]
    mlf_j, mlf_t = str(tmp_path / "j.mlf"), str(tmp_path / "t.mlf")
    _run_cli(jcli.main, pkg, "post", "str", posts, str(tmp_path / "j"),
             mlf_j)
    _run_cli(cli.main, pkg, "post", "str", posts, str(tmp_path / "t"),
             mlf_t)
    want, got = read_mlf(mlf_j), read_mlf(mlf_t)
    assert list(got) == list(want)
    for k in want:
        assert _key(got[k]) == _key(want[k])
    raw = open(case["wavs"][0], "rb").read()
    for s in (sr, jsr):
        with pytest.raises(RuntimeError, match="^The 'traps' module have to "
                           "be enabled for generating posteriors$"):
            s.process_offline("wf", "post", raw)
        with pytest.raises(RuntimeError, match="'traps' module"):
            s.posteriors_from_params(np.zeros((4, 5), np.float32))
    assert not sr._can_batch_list("wf", "str")


def test_error_messages_match_jax(case):
    sr, jsr = case["srs"]["lcrc"], case["jsrs"]["lcrc"]
    for s in (sr, jsr):
        with pytest.raises(ValueError,
                           match="^Invalid dimensionality of parameter "
                                 "vectors$"):
            s.posteriors_from_params(np.zeros((4, 4), np.float32))
        with pytest.raises(ValueError, match="must be later than input"):
            s.process_offline("post", "par", np.zeros((4, 12), np.float32))
        with pytest.raises(ValueError, match="Invalid data format 'mfc'"):
            s.process_offline("wf", "mfc", b"")
    # par is truncated to n_params columns before the estimator
    par = sr.params_from_waveform(open(case["wavs"][1], "rb").read())
    wide = np.concatenate([par, np.ones_like(par)], axis=1)
    np.testing.assert_array_equal(sr.posteriors_from_params(wide),
                                  sr.posteriors_from_params(par))


@pytest.mark.parametrize("inpf, outpf", PAIRS,
                         ids=[f"{a}-{b}" for a, b in PAIRS])
def test_batched_lists_where_jax_batches(case, inpf, outpf, tmp_path):
    """process_file_list runs batched exactly where phnrec_tpu's
    _can_batch_list does (wf -> str on the mel frontend without dither),
    on the LCRC and stkint packages, with PLP and with dither."""
    plp = synth.write_lcrc_package(tmp_path / "plp", "tiny", seed=0,
                                   plp=True)
    dith = synth.write_lcrc_package(tmp_path / "dith", "tiny", seed=0)
    with open(os.path.join(dith, "config"), "a") as f:
        f.write("[source]\nnoise_level=2.0\n")
    srs = dict(case["srs"], plp=SpeechRec(plp, device="cpu"),
               dith=SpeechRec(dith, device="cpu"))
    jsrs = dict(case["jsrs"], plp=JSpeechRec(plp), dith=JSpeechRec(dith))
    for k, sr in srs.items():
        assert sr._can_batch_list(inpf, outpf) == \
            jsrs[k]._can_batch_list(inpf, outpf), k
