"""The port's whole-utterance Xform application against phnrec_tpu's on the
same parsed transforms and numpy-seeded inputs: every kind (linear, bias,
copy, the five functions, stacking, composite), instance chains and a
parsed global <InputXform>, at [T, D] and with leading batch dims."""

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
