"""The port's whole-utterance Xform application against phnrec_tpu's on the
same parsed transforms and numpy-seeded inputs: every kind (linear, bias,
copy, the five functions, stacking, composite), instance chains and a
parsed global <InputXform>, at [T, D] and with leading batch dims."""

import jax
import numpy as np
import pytest
import torch

from phnrec_tpu.io import mmf as jmmf
from phnrec_tpu.io import xform as jxf

from phnrec_tpu_torch.io import mmf as tmmf
from phnrec_tpu_torch.io import xform as txf

# float32 products of up to 8 terms of magnitude <= 1 summed in another
# order, and exp/log/sigmoid/softmax of libm against XLA: a few ulp of
# values below 8
ATOL = 1e-6

XFORMS = {
    "linear": "<Xform> 3 4  0.5 -0.25 0.125 1  -1 0.75 0.5 -0.5  "
              "0.3 0.2 -0.1 0.6",
    "bias": "<Bias> 4 0.5 -0.5 0.25 1.5",
    "copy": "<Copy> 5 4  1:2:3 4 2:3",
    "sigmoid": "<Sigmoid> 4",
    "log": "<Log> 4",
    "exp": "<Exp> 4",
    "sqrt": "<Sqrt> 4",
    "softmax": "<SoftMax> 4",
    "stacking": "<Stacking> 3 4",
    "stacking_long": "<Stacking> 6 4",
    "composite": """<NumLayers> 2
        <Layer> 1 <NumBlocks> 2
          <Block> 1 <Xform> 2 2  2 0.5  -0.5 2
          <Block> 2 <Bias> 2  1 -1
        <Layer> 2 <Sigmoid> 4""",
}

MMF = """~o <VecSize> 4 <PDFObsVec>
~x "lin" <Xform> 4 4  1 0.5 0 0  0 1 0.5 0  0 0 1 0.5  0.5 0 0 1
~x "b" <Bias> 4 0.5 -0.5 0.25 0
~j "base" <VecSize> 4 ~x "lin"
~j "stacked" <Input> ~j "base" <VecSize> 8 <Stacking> 2 4
<InputXform> <Input> ~j "base" <VecSize> 4 ~x "b"
"""


def _inputs(shape, seed=0):
    x = np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)
    return x


def _jax(apply, obj, x):
    """JAX's function on [T, D], row by row for leading batch dims."""
    if x.ndim == 2:
        return np.asarray(apply(obj, x))
    return np.stack([_jax(apply, obj, r) for r in x])


@pytest.mark.parametrize("shape", [(7, 4), (3, 7, 4), (2, 2, 5, 4)],
                         ids=["T", "B-T", "B-B-T"])
@pytest.mark.parametrize("kind", list(XFORMS))
def test_apply_xform_matches_jax(kind, shape):
    jx = jxf.parse_xform(jmmf._Tok(XFORMS[kind]), {})
    tx = txf.parse_xform(tmmf._Tok(XFORMS[kind]), {})
    x = _inputs(shape)
    if kind in ("log", "sqrt"):
        x = np.abs(x) + (0 if kind == "sqrt" else 1e-3)
    x[..., 0, 1] = 0.0 if kind != "log" else x[..., 0, 1]
    want = _jax(jxf.apply_xform, jx, x)
    got = txf.apply_xform(tx, torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("which", ["base", "stacked", "input_xform"])
def test_apply_instance_matches_jax(which, tmp_path):
    p = tmp_path / "x.mmf"
    p.write_text(MMF)
    _, jj, jin = jxf.parse_mmf_xforms(str(p))
    _, tj, tin = txf.parse_mmf_xforms(str(p))
    jinst = jin if which == "input_xform" else jj[which]
    tinst = tin if which == "input_xform" else tj[which]
    assert tinst.total_delay == jinst.total_delay
    for shape in ((6, 4), (3, 6, 4)):
        x = _inputs(shape, seed=1)
        want = _jax(jxf.apply_instance, jinst, x)
        got = txf.apply_instance(tinst, torch.from_numpy(x)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_mmf_input_xform_through_the_model_set(tmp_path):
    """The model set's parsed ``input_xform`` (the chain the STK decoder
    applies) gives the reference's observations."""
    p = tmp_path / "g.mmf"
    p.write_text(MMF)
    jms, tms = jmmf.parse_mmf(str(p)), tmmf.parse_mmf(str(p))
    x = _inputs((2, 9, 4), seed=2)
    want = _jax(jxf.apply_instance, jms.input_xform, x)
    got = txf.apply_instance(tms.input_xform, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


# -- carried-state (streaming) forms ------------------------------------------
STATEFUL = {
    "stacking": "<Stacking> 3 4",
    "composite": """<NumLayers> 2
        <Layer> 1 <NumBlocks> 2
          <Block> 1 <Stacking> 2 2
          <Block> 2 <Bias> 2  1 -1
        <Layer> 2 <Bias> 6  0.5 -0.5 0.25 1 -1 0.125""",
}

CHAIN_MMF = MMF + '~j "chain" <Input> ~j "stacked" <VecSize> 24 ' \
    '<Stacking> 3 8\n'


def _stateful_objs(which, tmp_path):
    """(JAX object, port object, apply-kind) of a stateful case: an Xform
    (``stacking``, ``composite``) or a parsed instance chain (``chain``:
    linear -> stacking 2 -> stacking 3; ``input_xform``: no stacking)."""
    if which in STATEFUL:
        return (jxf.parse_xform(jmmf._Tok(STATEFUL[which]), {}),
                txf.parse_xform(tmmf._Tok(STATEFUL[which]), {}), "xform")
    p = tmp_path / "c.mmf"
    p.write_text(CHAIN_MMF)
    _, jj, jin = jxf.parse_mmf_xforms(str(p))
    _, tj, tin = txf.parse_mmf_xforms(str(p))
    if which == "chain":
        return jj["chain"], tj["chain"], "instance"
    return jin, tin, "instance"


def _fns(kind):
    if kind == "xform":
        return ((jxf.xform_init_state, jxf.apply_xform_stateful,
                 jxf.apply_xform_stateful_ragged, jxf.apply_xform),
                (txf.xform_init_state, txf.apply_xform_stateful,
                 txf.apply_xform_stateful_ragged, txf.apply_xform))
    return ((jxf.instance_init_state, jxf.apply_instance_stateful,
             jxf.apply_instance_stateful_ragged, jxf.apply_instance),
            (txf.instance_init_state, txf.apply_instance_stateful,
             txf.apply_instance_stateful_ragged, txf.apply_instance))


def _in_size(obj):
    return obj.in_size if hasattr(obj, "in_size") else \
        _in_size(obj.input) if obj.input is not None else obj.xform.in_size


def _leaves(st):
    if st is None:
        return []
    if isinstance(st, (list, tuple)):
        return [x for s in st for x in _leaves(s)]
    return [np.asarray(st)]


STATEFUL_CASES = ["stacking", "composite", "chain", "input_xform"]


@pytest.mark.parametrize("which", STATEFUL_CASES)
def test_stateful_chunks_match_jax(which, tmp_path):
    """Chunk by chunk from the zero state, the port's outputs and carried
    states equal JAX's (ATOL: the chain's linear node)."""
    jo, to, kind = _stateful_objs(which, tmp_path)
    (j_init, j_apply, _, _), (t_init, t_apply, _, _) = _fns(kind)
    x = _inputs((13, _in_size(to)), seed=3)
    jst, tst = j_init(jo), t_init(to)
    for lo, hi in ((0, 4), (4, 5), (5, 13)):
        jst, jy = j_apply(jo, jst, x[lo:hi])
        tst, ty = t_apply(to, tst, torch.from_numpy(x[lo:hi]))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                                   atol=ATOL)
        for a, b in zip(_leaves(tst), _leaves(jst), strict=True):
            np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


@pytest.mark.parametrize("splits", [(1,), (3, 4), (5, 6, 7, 11), (12,)],
                         ids=lambda s: "-".join(map(str, s)))
@pytest.mark.parametrize("which", STATEFUL_CASES)
def test_stateful_chunks_equal_whole_utterance(which, splits, tmp_path):
    """Chunked at any split points, batched over two leading streams, the
    concatenated outputs equal the whole-utterance apply bit for bit, and
    StreamingXform gives the same."""
    _, to, kind = _stateful_objs(which, tmp_path)
    _, (t_init, t_apply, _, t_whole) = _fns(kind)
    x = torch.from_numpy(_inputs((2, 13, _in_size(to)), seed=4))
    want = t_whole(to, x)
    st, outs = t_init(to, (2,)), []
    edges = (0, *splits, 13)
    for lo, hi in zip(edges, edges[1:]):
        st, y = t_apply(to, st, x[:, lo:hi])
        outs.append(y)
    assert torch.equal(torch.cat(outs, dim=1), want)
    if kind == "instance":
        sx = txf.StreamingXform(to, (2,), device="cpu")
        assert torch.equal(torch.cat([sx(x[:, lo:hi]) for lo, hi in
                                      zip(edges, edges[1:])], dim=1), want)


@pytest.mark.parametrize("which", STATEFUL_CASES)
def test_stateful_ragged_matches_jax(which, tmp_path):
    """The ragged form over 4 streams, blocks of 5 rows with per-stream
    valid counts (0, 2, 5 and a stream that idles then fills): every
    stream's valid output rows and carried state equal JAX's (vmapped
    there, row by row here), and each stream's valid rows concatenated
    equal the whole-utterance apply of its frames."""
    jo, to, kind = _stateful_objs(which, tmp_path)
    (j_init, _, j_ragged, _), (t_init, _, t_ragged, t_whole) = _fns(kind)
    D = _in_size(to)
    rng = np.random.default_rng(5)
    counts = [(5, 0, 2, 5), (0, 2, 5, 5), (3, 5, 0, 1)]
    frames = [_inputs((sum(c[b] for c in counts), D), seed=10 + b)
              for b in range(4)]
    jst = [j_init(jo) for _ in range(4)]
    tst = t_init(to, (4,))
    pos, got = [0] * 4, [[] for _ in range(4)]
    for nv in counts:
        x = rng.uniform(-9, 9, (4, 5, D)).astype(np.float32)  # padding
        for b in range(4):
            x[b, :nv[b]] = frames[b][pos[b]: pos[b] + nv[b]]
        tst, ty = t_ragged(to, tst, torch.from_numpy(x),
                           torch.tensor(nv, dtype=torch.int32))
        for b in range(4):
            jst[b], jy = j_ragged(jo, jst[b], x[b], jax.numpy.int32(nv[b]))
            np.testing.assert_allclose(ty[b, :nv[b]].numpy(),
                                       np.asarray(jy)[:nv[b]], rtol=0,
                                       atol=ATOL)
            got[b].append(ty[b, :nv[b]])
            pos[b] += nv[b]
        for b in range(4):
            for a, w in zip(_leaves(tst), _leaves(jst[b]), strict=True):
                np.testing.assert_allclose(a[b], w, rtol=0, atol=ATOL)
    for b in range(4):
        whole = t_whole(to, torch.from_numpy(frames[b]))
        assert torch.equal(torch.cat(got[b]), whole)


def test_stateful_ragged_full_equals_stateful():
    """With every row valid the ragged form is the plain stateful form."""
    to = txf.parse_xform(tmmf._Tok(STATEFUL["composite"]), {})
    x = torch.from_numpy(_inputs((3, 6, 4), seed=6))
    st0 = txf.xform_init_state(to, (3,))
    sa, ya = txf.apply_xform_stateful(to, st0, x)
    sb, yb = txf.apply_xform_stateful_ragged(to, st0, x,
                                             torch.full((3,), 6))
    assert torch.equal(ya, yb)
    for a, b in zip(_leaves(sa), _leaves(sb), strict=True):
        assert np.array_equal(a, b)
