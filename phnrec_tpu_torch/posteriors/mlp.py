"""2-layer MLP forward pass (input -> sigmoid hidden -> softmax output).

Counterpart of phnrec_tpu/posteriors/mlp.py.  Reference:
NeuralNet::ForwardPass1Bunch (nn.cpp:872-899): input normalization
``(x - mean) * dev`` (nn.cpp:702-716), two GEMMs with biases (nn.cpp:721-794),
fast sigmoid/softmax (nn.cpp:796-855 under NN_FAST_EXP).

The weights are stored unpadded and transposed for ``x @ w``: w1 is
[n_inp, n_hid] and w2 [n_hid, n_out].  ``forward`` reads the precision mode
(precision.py) at each call: at ``highest`` it runs kernel A
(ops/mlp_fused.py), at ``high`` and ``default`` kernel A'
(ops/mlp_bf16x3.py) with 3 or 1 bf16 passes, on the bf16 hi/lo halves of
w1 and w2 that the module splits once, at construction.  CUDA tensors
launch the kernel, CPU tensors take its plain version.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from phnrec_tpu_torch import precision
from phnrec_tpu_torch.io.weights import MLPParams
from phnrec_tpu_torch.ops import mlp_bf16x3, mlp_fused


class MLP(nn.Module):
    def __init__(self, w1: np.ndarray, b1: np.ndarray, w2: np.ndarray,
                 b2: np.ndarray, mean: np.ndarray, dev: np.ndarray):
        """w1 [n_inp, n_hid], w2 [n_hid, n_out]; vectors unpadded."""
        super().__init__()
        n_inp, n_hid = w1.shape
        n_out = w2.shape[1]
        if w2.shape[0] != n_hid or b1.shape != (n_hid,) or \
                b2.shape != (n_out,) or mean.shape != (n_inp,) or \
                dev.shape != (n_inp,):
            raise ValueError("inconsistent MLP parameter shapes")
        for name, a in (("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2),
                        ("mean", mean), ("dev", dev)):
            self.register_buffer(
                name, torch.tensor(np.ascontiguousarray(a, np.float32)))
        # kernel A''s operands: split and padded once, moved with the module
        for name, t in zip(("w1_hi", "w1_lo", "w2_hi", "w2_lo"),
                           mlp_bf16x3.split_weights(self.w1, self.w2)):
            self.register_buffer(name, t, persistent=False)
        self.n_inp, self.n_hid, self.n_out = n_inp, n_hid, n_out

    @classmethod
    def from_params(cls, p: MLPParams) -> "MLP":
        """From the on-disk layout (w1 [n_hid, n_inp], w2 [n_out, n_hid])."""
        return cls(p.w1.T, p.b1, p.w2.T, p.b2, p.mean, p.dev)

    def forward(self, x: torch.Tensor, fast: bool = True,
                apply_softmax: bool = True,
                plain: bool = False) -> torch.Tensor:
        """[..., n_inp] -> [..., n_out] posteriors through the kernel the
        precision mode selects.  ``plain`` runs that kernel's plain version
        on any device (the reference run)."""
        lead = x.shape[:-1]
        x2 = x.reshape(-1, self.n_inp).contiguous()
        passes = precision.mlp_passes()
        if passes:
            fn = (mlp_bf16x3.mlp_forward_bf16x3_plain if plain
                  else mlp_bf16x3.mlp_forward_bf16x3)
            o = fn(x2, self.mean, self.dev, self.w1_hi, self.w1_lo, self.b1,
                   self.w2_hi, self.w2_lo, self.b2, fast=fast,
                   apply_softmax=apply_softmax, passes=passes)
        else:
            fn = (mlp_fused.mlp_forward_plain if plain
                  else mlp_fused.mlp_forward)
            o = fn(x2, self.mean, self.dev, self.w1, self.b1, self.w2,
                   self.b2, fast=fast, apply_softmax=apply_softmax)
        return o.reshape(*lead, self.n_out)
