"""phnrec_tpu_torch stands alone: it imports without JAX, no module of it
imports jax or phnrec_tpu, its kernel wrappers run the plain version only
for CPU tensors (counting no launch) and raise for any other non-CUDA
tensor, and the kernel build raises rather than falling back."""

import ast
import os
import pkgutil
import stat
import subprocess
import sys

import numpy as np
import pytest
import torch

import phnrec_tpu_torch
from phnrec_tpu_torch import synth
from phnrec_tpu_torch.decoder.stknet import OFF_BEAM, NetworkDecoder
from phnrec_tpu_torch.ops import (_build, backtrack, mlp_bf16x3, mlp_fused,
                                  netdecode, netscan, nettrace,
                                  phnloop_viterbi)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(phnrec_tpu_torch.__file__)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG], prefix="phnrec_tpu_torch."))


def _py_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return out


def test_imports_without_jax():
    mods = _modules()
    assert "phnrec_tpu_torch.parallel.batch" in mods and len(mods) > 20
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['phnrec_tpu'] = None\n"
            "import phnrec_tpu_torch\n"
            f"for m in {mods!r} + ['chip_smoke']:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith('jax.') for k, v in "
            "sys.modules.items() if v is not None)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", _py_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "phnrec_tpu"), \
                f"{path}:{node.lineno} imports {n}"


def _mlp_args(device="cpu"):
    rng = np.random.default_rng(0)
    t = lambda *s: torch.tensor(rng.standard_normal(s).astype(np.float32),
                                device=device)  # noqa: E731
    return (t(5, 7), t(7), t(7), t(7, 6), t(6), t(6, 4), t(4))


def _bf16x3_args(device="cpu"):
    x, mean, dev, w1, b1, w2, b2 = _mlp_args()
    w1h, w1l, w2h, w2l = mlp_bf16x3.split_weights(w1, w2)
    return tuple(a.to(device) for a in (x, mean, dev, w1h, w1l, b1, w2h,
                                        w2l, b2))


def _viterbi_args(device="cpu"):
    P, S, B, T = 3, 2, 2, 9
    lp = torch.log_softmax(torch.randn(B, T, P * S), -1).to(device)
    carry = (torch.zeros(P, S + 1, B, device=device),
             torch.zeros(P, S + 1, B, dtype=torch.int32, device=device))
    return (carry, lp, 0, P, S, -2.0, -0.7, -0.7)


def _ragged_args(device="cpu"):
    carry, lp, _, *rest = _viterbi_args(device)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32,  # noqa: E731
                                 device=device)
    return (carry, lp, i32([4, 0]), i32([9, 3]), *rest)


def _hist_args(device="cpu"):
    T, B = 12, 3
    return (torch.zeros(T, B, dtype=torch.int8, device=device),
            torch.arange(T, dtype=torch.int32, device=device)[:, None]
            .expand(T, B).contiguous() // 3 * 3,
            torch.zeros(T, B, device=device),
            torch.full((B,), T, dtype=torch.int32, device=device), 5)


def _committed_args(device="cpu"):
    max_phn, ent, alpha, n_frames, smax = _hist_args(device)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32,  # noqa: E731
                                 device=device)
    return (max_phn, ent, alpha, n_frames, i32([2, 0, 5]), i32([0, 0, 3]),
            smax)


def _netscan_args(device="cpu"):
    dec = NetworkDecoder(synth.random_network(5, seed=2))
    B, T = 3, 9
    rng = np.random.default_rng(0)
    obs = torch.tensor(-rng.integers(0, 8, (B, T, dec.c.n_states)) / 4,
                       dtype=torch.float32, device=device)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32,  # noqa: E731
                                 device=device)
    return (dec.init_carry(device, B), obs, i32([0, 4, 0]), i32([9, 6, 0]),
            torch.tensor([OFF_BEAM, 2.0, OFF_BEAM], device=device),
            dec.edge_tables(device))


def _nettrace_args(device="cpu"):
    _, recs = netscan.netscan_plain(*_netscan_args())
    tb = _netscan_args(device)[-1]
    i32 = lambda v: torch.tensor(v, dtype=torch.int32,  # noqa: E731
                                 device=device)
    return ({k: v.to(device) for k, v in recs.items()}, i32([9, 6, 0]),
            i32([-1, 3, -1]), tb, 0)


def _netdecode_args(device="cpu"):
    dense = synth.dense_kws_net(4, 2, 2, seed=3)
    rng = np.random.default_rng(1)
    obs = torch.tensor(-rng.integers(0, 8, (2, 7, dense.E)) / 4,
                       dtype=torch.float32, device=device)
    return (netdecode.build_net_decode_fn(dense),
            tuple(t.to(device) for t in dense.init_carry_decode(2)), obs,
            torch.tensor([7, 3], dtype=torch.int32, device=device),
            torch.full((2,), float(OFF_BEAM), device=device))


def _counts():
    return (mlp_fused.LAUNCHES, mlp_bf16x3.LAUNCHES, phnloop_viterbi.LAUNCHES,
            phnloop_viterbi.RAGGED_LAUNCHES, backtrack.LAUNCHES,
            backtrack.COMMITTED_LAUNCHES, netscan.LAUNCHES,
            nettrace.LAUNCHES, netdecode.LAUNCHES)


def _assert_nested_equal(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    else:
        for x, y in zip(a, b):
            _assert_nested_equal(x, y)


def test_wrappers_run_plain_on_cpu_without_counting():
    before = _counts()
    a = _mlp_args()
    assert torch.equal(mlp_fused.mlp_forward(*a),
                       mlp_fused.mlp_forward_plain(*a))
    for passes in (1, 3):
        a = _bf16x3_args()
        assert torch.equal(
            mlp_bf16x3.mlp_forward_bf16x3(*a, passes=passes),
            mlp_bf16x3.mlp_forward_bf16x3_plain(*a, passes=passes))
    v = _viterbi_args()
    _assert_nested_equal(phnloop_viterbi.viterbi_block(*v),
                         phnloop_viterbi.viterbi_block_plain(*v))
    r = _ragged_args()
    _assert_nested_equal(phnloop_viterbi.viterbi_block_ragged(*r),
                         phnloop_viterbi.viterbi_block_ragged_plain(*r))
    h = _hist_args()
    _assert_nested_equal(backtrack.backtrack(*h),
                         backtrack.backtrack_plain(*h))
    c = _committed_args()
    _assert_nested_equal(backtrack.backtrack_committed(*c),
                         backtrack.backtrack_committed_plain(*c))
    g = _netscan_args()
    (carry, recs), (carry_p, recs_p) = (netscan.netscan(*g),
                                        netscan.netscan_plain(*g))
    _assert_nested_equal(carry, carry_p)
    _assert_nested_equal([recs[k] for k in netscan.RECORDS],
                         [recs_p[k] for k in netscan.RECORDS])
    h = _nettrace_args()
    _assert_nested_equal(nettrace.nettrace(*h), nettrace.nettrace_plain(*h))
    blk, *e = _netdecode_args()
    (c, r), (cp, rp) = (blk(*e), netdecode.net_decode_block_plain(
        blk.dense, *e))
    _assert_nested_equal(c, cp)
    _assert_nested_equal([r[k] for k in netdecode.RECORDS],
                         [rp[k] for k in netdecode.RECORDS])
    assert _counts() == before


def test_wrappers_raise_off_cpu_without_cuda():
    """A tensor on neither the CPU nor a CUDA device gets no plain
    fallback: the wrapper raises and counts nothing."""
    before = _counts()
    for fn, args in ((mlp_fused.mlp_forward, _mlp_args("meta")),
                     (mlp_bf16x3.mlp_forward_bf16x3, _bf16x3_args("meta")),
                     (phnloop_viterbi.viterbi_block, _viterbi_args("meta")),
                     (phnloop_viterbi.viterbi_block_ragged,
                      _ragged_args("meta")),
                     (backtrack.backtrack, _hist_args("meta")),
                     (backtrack.backtrack_committed,
                      _committed_args("meta")),
                     (netscan.netscan, _netscan_args("meta")),
                     (nettrace.nettrace, _nettrace_args("meta")),
                     (lambda blk, *a: blk(*a), _netdecode_args("meta"))):
        with pytest.raises(ValueError, match="no kernel"):
            fn(*args)
    assert _counts() == before


def _wide_args(kernel, n_inp, n_out, device):
    """Zero operands of kernel A or A' for a net of n_inp -> 6 -> n_out."""
    z = lambda *s, dt=torch.float32: torch.zeros(  # noqa: E731
        *s, dtype=dt, device=device)
    if kernel == "mlp_fused":
        return (z(5, n_inp), z(n_inp), z(n_inp), z(n_inp, 6), z(6),
                z(6, n_out), z(n_out))
    kp, op, bf = -(-n_inp // 16) * 16, -(-n_out // 16) * 16, torch.bfloat16
    return (z(5, n_inp), z(n_inp), z(n_inp), z(kp, 128, dt=bf),
            z(kp, 128, dt=bf), z(6), z(128, op, dt=bf), z(128, op, dt=bf),
            z(n_out))


_FORWARD = {"mlp_fused": mlp_fused.mlp_forward,
            "mlp_bf16x3": mlp_bf16x3.mlp_forward_bf16x3}


@pytest.mark.parametrize("kernel, n_inp, n_out, what", [
    pytest.param("mlp_fused", mlp_fused.MAX_INP + 1, 4, "n_inp",
                 id=f"{mlp_fused.MAX_INP + 1}-4-n_inp"),
    pytest.param("mlp_fused", 7, mlp_fused.MAX_OUT + 1, "n_out",
                 id=f"7-{mlp_fused.MAX_OUT + 1}-n_out"),
    pytest.param("mlp_bf16x3", mlp_fused.MAX_INP + 1, 4, "n_inp",
                 id=f"bf16x3-{mlp_fused.MAX_INP + 1}-4-n_inp"),
    pytest.param("mlp_bf16x3", 7, mlp_fused.MAX_OUT + 1, "n_out",
                 id=f"bf16x3-7-{mlp_fused.MAX_OUT + 1}-n_out")])
def test_mlp_fused_raises_beyond_its_widths(kernel, n_inp, n_out, what,
                                            monkeypatch):
    """Kernels A and A' keep the x tile in shared memory and the outputs in
    registers, and their fused kernels take the same widths; a wider net
    (past n_inp or n_out, ``what``) takes the split path instead of
    raising.  On a device that is not CUDA the wrapper still raises before
    anything is built or launched, and the CPU path (the plain version)
    takes the net."""
    def no_build(name):
        raise AssertionError(f"built {name}")
    monkeypatch.setattr(_build, "load", no_build)
    assert not mlp_fused.fused_takes(n_inp, n_out), what
    before = _counts()
    with pytest.raises(ValueError, match="no kernel"):
        _FORWARD[kernel](*_wide_args(kernel, n_inp, n_out, "meta"))
    assert _counts() == before
    cpu = _wide_args(kernel, n_inp, n_out, "cpu")
    assert _FORWARD[kernel](*cpu).shape == (5, n_out)
    # the widest net the fused kernels take
    assert mlp_fused.fused_takes(mlp_fused.MAX_INP, mlp_fused.MAX_OUT)


@pytest.mark.parametrize("kernel", ["mlp_fused", "mlp_bf16x3"])
def test_mlp_fused_limits_match_the_source(kernel):
    """The wrapper's limits are the ones each CUDA source exports: one pair
    for kernels A and A'."""
    src = open(os.path.join(PKG, "csrc", f"{kernel}.cu")).read()
    assert f"constexpr int MAX_INP = {mlp_fused.MAX_INP};" in src
    assert f"phn_{kernel}_max_inp() {{ return MAX_INP; }}" in src
    if kernel == "mlp_fused":
        assert "constexpr int MAX_NQ = 8;" in src and \
            mlp_fused.MAX_OUT == 32 * 8
        assert "phn_mlp_fused_max_out() { return 32 * MAX_NQ; }" in src
    else:
        assert f"constexpr int MAX_OUT = {mlp_fused.MAX_OUT};" in src
        assert "phn_mlp_bf16x3_max_out() { return MAX_OUT; }" in src


def test_require_checks():
    x = torch.zeros(4, 3)
    _build.require(x, "x", torch.float32, (4, 3), x.device)
    with pytest.raises(TypeError):
        _build.require(x.double(), "x", torch.float32, (4, 3), x.device)
    with pytest.raises(ValueError, match="shape"):
        _build.require(x, "x", torch.float32, (3, 4), x.device)
    with pytest.raises(ValueError, match="contiguous"):
        _build.require(x.t(), "x", torch.float32, (3, 4), x.device)


def _fake_nvcc(tmp_path, body):
    p = tmp_path / "nvcc"
    p.write_text("#!/bin/sh\n" + body)
    p.chmod(p.stat().st_mode | stat.S_IXUSR)
    return str(p)


def test_build_raises_with_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(_build, "find_nvcc", lambda: _fake_nvcc(
        tmp_path, "echo 'error: no such thing' >&2\nexit 2\n"))
    with pytest.raises(_build.KernelBuildError, match="no such thing"):
        _build.build("backtrack")
    assert list((tmp_path / "out").iterdir()) == []


def test_build_renames_and_caches(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "out")
    log = tmp_path / "calls"
    # writes its -o argument, the second-to-last one
    nvcc = _fake_nvcc(tmp_path, f'echo x >> {log}\n'
                      'for a; do prev2=$prev; prev=$a; done\n'
                      'echo lib > "$prev2"\n')
    monkeypatch.setattr(_build, "find_nvcc", lambda: nvcc)
    out = _build.build("backtrack")
    assert out.read_text() == "lib\n" and out.name.startswith("libbacktrack-")
    assert [p.name for p in (tmp_path / "out").iterdir()] == [out.name]
    assert _build.build("backtrack") == out
    assert log.read_text().count("x") == 1


def test_find_nvcc_raises_when_missing(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.find_nvcc()


def _bands_args(device="cpu", passes=0):
    """A stack of three nets of the _mlp_args topology: kernel A's or A′'s
    band-stack arguments."""
    rng = np.random.default_rng(5)

    def t(*s):
        return torch.tensor(rng.standard_normal(s).astype(np.float32))

    x, mean, dev, b1, b2 = t(3, 5, 7), t(3, 7), t(3, 7), t(3, 6), t(3, 4)
    w1, w2 = t(3, 7, 6), t(3, 6, 4)
    if passes:
        parts = [mlp_bf16x3.split_weights(w1[b], w2[b]) for b in range(3)]
        w1h, w1l, w2h, w2l = (torch.stack(p) for p in zip(*parts))
        args = (x, mean, dev, w1h, w1l, b1, w2h, w2l, b2)
    else:
        args = (x, mean, dev, w1, b1, w2, b2)
    return tuple(a.to(device) for a in args)


def _lrtrace_args(device="cpu"):
    from phnrec_tpu_torch.devtools.scan_variants import lrtrace_case
    return (*lrtrace_case(device, 2, 20, 3, 5, seed=1), 40, -1e30)


def test_new_modules_import_without_jax():
    """The PLP frontend, the estimators with the band stack, the
    streaming recognizer's stkint modes and the device tracker import
    with JAX and phnrec_tpu blocked."""
    mods = ["phnrec_tpu_torch.frontend.plp",
            "phnrec_tpu_torch.posteriors.estimator",
            "phnrec_tpu_torch.streaming", "phnrec_tpu_torch.convert"]
    assert set(mods) <= set(_modules())
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['phnrec_tpu'] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "from phnrec_tpu_torch.decoder.stknet import DeviceKWSTracker\n"
            "from phnrec_tpu_torch.posteriors.estimator import (\n"
            "    BandStack, DCTEstimator, TrapsEstimator)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_band_and_settings_wrappers_plain_on_cpu_raise_elsewhere():
    """The band-stack wrappers of kernels A and A′ and kernel F with
    LRTrace's other settings run their plain versions on CPU tensors
    (counting nothing) and raise for any other non-CUDA tensor, as does
    DeviceKWSTracker on such tensors."""
    from phnrec_tpu_torch.decoder.stknet import DeviceKWSTracker
    from phnrec_tpu_torch.ops import lrtrace
    def counts():
        return (_counts(), lrtrace.LAUNCHES, mlp_fused.BAND_LAUNCHES,
                mlp_bf16x3.BAND_LAUNCHES)

    before = counts()
    a = _bands_args()
    assert torch.equal(mlp_fused.mlp_forward_bands(*a),
                       mlp_fused.mlp_forward_bands_plain(*a))
    a = _bands_args(passes=3)
    for passes in (1, 3):
        assert torch.equal(
            mlp_bf16x3.mlp_forward_bf16x3_bands(*a, passes=passes),
            mlp_bf16x3.mlp_forward_bf16x3_bands_plain(*a, passes=passes))
    for improve, quirk in ((True, True), (False, False)):
        _assert_nested_equal(
            lrtrace.lrtrace_scan(*_lrtrace_args(), improve, quirk)[0],
            lrtrace.lrtrace_scan_plain(*_lrtrace_args(), improve, quirk)[0])
    for fn, args in (
            (mlp_fused.mlp_forward_bands, _bands_args("meta")),
            (mlp_bf16x3.mlp_forward_bf16x3_bands, _bands_args("meta", 3)),
            (lambda *x: lrtrace.lrtrace_scan(*x, True, False),
             _lrtrace_args("meta"))):
        with pytest.raises(ValueError, match="no kernel"):
            fn(*args)
    tr = DeviceKWSTracker(["a", "b"], 40, word_sinks=[0, 1], filler_sink=2,
                          device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tr.feed_sinks(torch.zeros(4, 3, device="meta"),
                      torch.zeros(4, 3, dtype=torch.int32, device="meta"))
    assert counts() == before


def _trainfb_args(device="cpu"):
    """A bucket of two 4-state graphs, 6 frames, ragged frame counts."""
    rng = np.random.default_rng(8)
    log_A = np.full((2, 4, 4), -1e10, np.float32)
    for i in range(4):
        log_A[:, i, i:i + 2] = np.log(0.5)
    t = lambda a, dt=torch.float32: torch.tensor(  # noqa: E731
        np.asarray(a), dtype=dt, device=device)
    return (t(log_A), t(np.log(np.eye(4, dtype=np.float32)[[0, 0]]
                               + 1e-30)),
            t(np.full((2, 4), np.log(0.5), np.float32)),
            t(rng.normal(size=(2, 6, 4)).astype(np.float32) - 2),
            t([6, 3], torch.int32))


def test_training_modules_and_scans_without_jax():
    """The staged pipeline, io/features, train/ and the phoneme-loop
    forward-backward import with JAX and phnrec_tpu blocked; kernels J, K
    and K' run their plain versions on CPU tensors (counting nothing) and
    raise for any other non-CUDA tensor before anything is built."""
    from phnrec_tpu_torch.ops import phnloop_fb, trainfb
    mods = ["phnrec_tpu_torch.io.features", "phnrec_tpu_torch.train",
            "phnrec_tpu_torch.train.loop", "phnrec_tpu_torch.train.mbr",
            "phnrec_tpu_torch.train.stk_accum",
            "phnrec_tpu_torch.train.update",
            "phnrec_tpu_torch.decoder.forward_backward",
            "phnrec_tpu_torch.ops.phnloop_fb", "phnrec_tpu_torch.ops.trainfb"]
    assert set(mods) <= set(_modules())
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['phnrec_tpu'] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "from phnrec_tpu_torch.train.loop import Reestimator\n"
            "from phnrec_tpu_torch.pipeline import STAGES\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr

    def counts():
        return (_counts(), phnloop_fb.LAUNCHES, phnloop_fb.GROUP_LAUNCHES,
                trainfb.LAUNCHES, trainfb.ALIGN_LAUNCHES)

    before = counts()
    lp = torch.log_softmax(torch.randn(2, 7, 14), -1)
    j = (3, 4, -1.0, -0.7, -0.7)
    _assert_nested_equal(phnloop_fb.phnloop_fb(lp, *j),
                         phnloop_fb.phnloop_fb_plain(lp, *j))
    a = _trainfb_args()
    _assert_nested_equal(trainfb.graph_fb(*a), trainfb.graph_fb_plain(*a))
    _assert_nested_equal(trainfb.graph_align(*a),
                         trainfb.graph_align_plain(*a))

    def no_build(name):
        raise AssertionError(f"built {name}")

    real = _build.load
    _build.load = no_build
    try:
        for fn, args in ((phnloop_fb.phnloop_fb, (lp.to("meta"), *j)),
                         (trainfb.graph_fb, _trainfb_args("meta")),
                         (trainfb.graph_align, _trainfb_args("meta"))):
            with pytest.raises(ValueError, match="no kernel"):
                fn(*args)
    finally:
        _build.load = real
    assert counts() == before
