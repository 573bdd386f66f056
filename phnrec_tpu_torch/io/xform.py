"""HTK/STK Xform feature-transform graphs: the parser and the
whole-utterance application.

The parser is a copy of phnrec_tpu/io/xform.py:1-202 (host code without
JAX, kept in step with it); ``apply_xform`` / ``apply_instance`` are the
counterparts of its :206-263 on torch tensors of any leading batch dims,
float32 with TF32 off.  The carried-state (streaming) forms and
``StreamingXform`` are the counterparts of its :266-371, batched the same
way: a stacking node's state is its last K-1 input frames, [..., K-1, in]
with the leading dims of the input (the multi-stream servers carry
[N, K-1, in], one FIFO a stream, where JAX vmaps an unbatched one).

Reference: the Xform machinery of STKLib/Models.h:891-1028 and the MMF
readers in Models_IO.cc (ReadXform 1306, ReadXformInstance 1188,
ReadLinearXform 1539, ReadBiasXform 1585, ReadFuncXform 1610,
ReadCopyXform 1630, ReadStackingXform 1678, ReadCompositeXform 1360).
Supported kinds — the complete set STK defines:

  <Xform> out in M        linear, y[c] = sum_r M[c,r] x[r]
  <Bias> n b              y = x + b
  <Copy> out in specs     index selection, specs ``from[:step[:to]]`` 1-based
  <Stacking> K in         FIFO frame stacking, output [x_{t-K+1}..x_t]
                          (oldest first, delay K-1, zero-initialized stack
                          as in StackingXform::Evaluate, Models.cc:2567+)
  <Sigmoid>/<Log>/<Exp>/<Sqrt>/<SoftMax> n   (gFuncTable, Models.cc:32-37)
  <NumLayers> L ... <Layer> i <NumBlocks>/<BlockInfo> k <Block> j ...
                          composite: sequential layers of block-diagonal
                          transforms (CompositeXform::Evaluate,
                          Models.cc:2332+)

Instances:  ~j "name" [<Input> <instance>] <VecSize> n <xform or ~x ref>
(XformInstance with delay chaining; Models_IO.cc:1188-1300).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from phnrec_tpu_torch.io.mmf import _Tok

_FUNC_KWDS = {"<SIGMOID>": "sigmoid", "<LOG>": "log", "<EXP>": "exp",
              "<SQRT>": "sqrt", "<SOFTMAX>": "softmax"}


@dataclass
class Xform:
    kind: str                      # linear|bias|copy|func|stacking|composite
    in_size: int
    out_size: int
    delay: int = 0
    matrix: Optional[np.ndarray] = None       # linear [out, in]
    vector: Optional[np.ndarray] = None       # bias [n]
    indices: Optional[np.ndarray] = None      # copy [out] 0-based
    func: Optional[str] = None                # func
    stack_size: int = 0                       # stacking
    layers: List[List["Xform"]] = field(default_factory=list)  # composite


@dataclass
class XformInstance:
    name: str
    xform: Xform
    input: Optional["XformInstance"] = None
    out_size: int = 0

    @property
    def total_delay(self) -> int:
        d = self.xform.delay
        return d + (self.input.total_delay if self.input else 0)


def _parse_copy_specs(tk: _Tok, out_size: int, in_size: int) -> np.ndarray:
    idx: List[int] = []
    while len(idx) < out_size:
        spec = tk.next()
        parts = spec.split(":")
        if len(parts) == 3:
            frm, step, to = int(parts[0]), int(parts[1]), int(parts[2])
        elif len(parts) == 2:
            frm, step, to = int(parts[0]), 1, int(parts[1])
        else:
            frm, step, to = int(parts[0]), 1, int(parts[0])
        if to < 1 or to > in_size:
            raise ValueError(f"copy index {to} out of range 1..{in_size}")
        for n in range((to - frm) // step + 1):
            idx.append(frm + n * step - 1)
    return np.asarray(idx[:out_size], np.int32)


def parse_xform(tk: _Tok, macros: Dict[str, Xform]) -> Xform:
    t = tk.next()
    u = t.upper()
    if t == "~x":
        name = tk.next().strip('"')
        return macros[name]
    if u == "<XFORM>":
        out_size, in_size = tk.get_int(), tk.get_int()
        m = tk.get_floats(out_size * in_size).reshape(out_size, in_size)
        return Xform("linear", in_size, out_size, matrix=m)
    if u == "<BIAS>":
        n = tk.get_int()
        return Xform("bias", n, n, vector=tk.get_floats(n))
    if u == "<COPY>":
        out_size, in_size = tk.get_int(), tk.get_int()
        idx = _parse_copy_specs(tk, out_size, in_size)
        return Xform("copy", in_size, out_size, indices=idx)
    if u == "<STACKING>":
        stack, in_size = tk.get_int(), tk.get_int()
        return Xform("stacking", in_size, stack * in_size,
                     delay=stack - 1, stack_size=stack)
    if u in _FUNC_KWDS:
        n = tk.get_int()
        return Xform("func", n, n, func=_FUNC_KWDS[u])
    if u in ("<NUMLAYERS>", "<NUMBLOCKS>", "<BLOCKINFO>"):
        nlayers = 1
        if u == "<NUMLAYERS>":
            nlayers = tk.get_int()
        else:
            tk.pos -= 1
        layers: List[List[Xform]] = [[] for _ in range(nlayers)]
        for _ in range(nlayers):
            t2 = tk.peek()
            layer_id = 1
            if t2 and t2.upper() == "<LAYER>":
                tk.next()
                layer_id = tk.get_int()
            t2 = tk.peek()
            nblocks = 1
            if t2 and t2.upper() == "<NUMBLOCKS>":
                tk.next()
                nblocks = tk.get_int()
            elif t2 and t2.upper() == "<BLOCKINFO>":
                tk.next()
                nblocks = tk.get_int()
                for _ in range(nblocks):
                    tk.get_int()          # block out sizes unused
            blocks: List[Optional[Xform]] = [None] * nblocks
            for _ in range(nblocks):
                t3 = tk.peek()
                block_id = 1
                if t3 and t3.upper() == "<BLOCK>":
                    tk.next()
                    block_id = tk.get_int()
                blocks[block_id - 1] = parse_xform(tk, macros)
            layers[layer_id - 1] = blocks   # type: ignore[assignment]
        in_size = sum(b.in_size for b in layers[0])
        out_size = sum(b.out_size for b in layers[-1])
        delay = sum(max((b.delay for b in lay), default=0) for lay in layers)
        return Xform("composite", in_size, out_size, delay=delay,
                     layers=layers)   # type: ignore[arg-type]
    raise ValueError(f"invalid Xform definition at {t!r}")


def parse_xform_instance(tk: _Tok, xmacros: Dict[str, Xform],
                         jmacros: Dict[str, XformInstance],
                         name: str = "") -> XformInstance:
    inp: Optional[XformInstance] = None
    t = tk.peek()
    if t == "~j":
        tk.next()
        return jmacros[tk.next().strip('"')]
    if t and t.upper() == "<INPUT>":
        tk.next()
        inp = parse_xform_instance(tk, xmacros, jmacros)
    t = tk.next()
    if t.upper() != "<VECSIZE>":
        raise ValueError("keyword <VecSize> expected in XformInstance")
    vec_size = tk.get_int()
    xf = parse_xform(tk, xmacros)
    if xf.out_size != vec_size:
        raise ValueError("XformInstance <VecSize> must equal Xform output"
                         f" size ({vec_size} != {xf.out_size})")
    return XformInstance(name=name, xform=xf, input=inp, out_size=vec_size)


def parse_mmf_xforms(path: str) -> Tuple[Dict[str, Xform],
                                         Dict[str, XformInstance],
                                         Optional[XformInstance]]:
    """Scan an MMF for ~x / ~j macros and the global <InputXform> option
    (Models_IO.cc:1781).  Returns (xforms, instances, input_xform)."""
    tk = _Tok(open(path, "r", encoding="latin-1").read())
    xmacros: Dict[str, Xform] = {}
    jmacros: Dict[str, XformInstance] = {}
    input_xform: Optional[XformInstance] = None
    while tk.peek() is not None:
        t = tk.next()
        if t == "~x":
            name = tk.next().strip('"')
            if tk.peek() == "~x":        # reference elsewhere, not a def
                continue
            xmacros[name] = parse_xform(tk, xmacros)
        elif t == "~j":
            name = tk.next().strip('"')
            if tk.peek() == "~j":
                continue
            jmacros[name] = parse_xform_instance(tk, xmacros, jmacros, name)
        elif t.upper() == "<INPUTXFORM>":
            input_xform = parse_xform_instance(tk, xmacros, jmacros,
                                               "~defaultInputXform")
    return xmacros, jmacros, input_xform


# -- batched application ----------------------------------------------------

def _f32(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=like.device)


def apply_xform(xf: Xform, x: torch.Tensor) -> torch.Tensor:
    """[..., T, in_size] -> [..., T, out_size], whole utterances at once
    (time is the second-to-last axis)."""
    if xf.kind == "linear":
        # a plain float32 product; TF32 stays off (SpeechRec sets it)
        return torch.matmul(x, _f32(xf.matrix.T, x))
    if xf.kind == "bias":
        return x + _f32(xf.vector, x)
    if xf.kind == "copy":
        return x[..., torch.as_tensor(xf.indices.astype(np.int64),
                                      device=x.device)]
    if xf.kind == "func":
        if xf.func == "sigmoid":
            return torch.sigmoid(x)
        if xf.func == "log":
            return torch.log(torch.clamp(x, min=1e-37))
        if xf.func == "exp":
            return torch.exp(x)
        if xf.func == "sqrt":
            return torch.sqrt(torch.clamp(x, min=0.0))
        if xf.func == "softmax":
            return torch.softmax(x, dim=-1)
        raise ValueError(f"unknown func xform {xf.func!r}")
    if xf.kind == "stacking":
        # output row t = [x_{t-K+1}, ..., x_t] (oldest first); frames
        # before the start are zeros: STK's stack memory starts zeroed
        K, T = xf.stack_size, x.shape[-2]
        pads = [torch.cat([x.new_zeros((*x.shape[:-2], min(K - 1 - k, T),
                                        x.shape[-1])),
                           x[..., : max(T - (K - 1 - k), 0), :]], dim=-2)
                for k in range(K)]
        return torch.cat(pads, dim=-1)
    if xf.kind == "composite":
        for layer in xf.layers:
            outs, off = [], 0
            for b in layer:
                outs.append(apply_xform(b, x[..., off:off + b.in_size]))
                off += b.in_size
            x = torch.cat(outs, dim=-1)
        return x
    raise ValueError(f"unknown xform kind {xf.kind!r}")


def apply_instance(inst: XformInstance, x: torch.Tensor) -> torch.Tensor:
    """Apply an XformInstance chain (input first) to [..., T, D]
    features."""
    if inst.input is not None:
        x = apply_instance(inst.input, x)
    return apply_xform(inst.xform, x)


# -- carried-state (streaming) application ----------------------------------
#
# The reference applies Xforms per frame with live delay-line memory
# (XformInstance stacks updated by ModelSet::UpdateStacks from every
# ViterbiStep, Viterbi.cc:2068, Models.h:891-1028).  apply_xform above is
# its whole-utterance equivalent; these are the CHUNKED equivalent: each
# stacking node carries its last K-1 input frames across chunks
# (zero-initialised, the zeroed stack memory of StackingXform::Evaluate),
# so a chunked stream equals the whole-utterance application bit for bit.

def xform_init_state(xf: Xform, lead: Tuple[int, ...] = (), device="cpu"):
    """Zero delay-line state mirroring the Xform's structure: [*lead, K-1,
    in] for a stacking node, nested lists for a composite, None for a
    stateless node."""
    if xf.kind == "stacking":
        return torch.zeros((*lead, xf.stack_size - 1, xf.in_size),
                           device=device)
    if xf.kind == "composite":
        return [[xform_init_state(b, lead, device) for b in layer]
                for layer in xf.layers]
    return None


def _stack(xf: Xform, st: torch.Tensor, x: torch.Tensor):
    """The stacking node's context [..., K-1+T, in] and output [..., T,
    K*in] (oldest frame first)."""
    T = x.shape[-2]
    ctx = torch.cat([st, x], dim=-2)
    return ctx, torch.cat([ctx[..., k: k + T, :]
                           for k in range(xf.stack_size)], dim=-1)


def _composite(xf: Xform, st, x: torch.Tensor, apply_one):
    new_state = []
    for layer, lst in zip(xf.layers, st):
        outs, nls, off = [], [], 0
        for b, bst in zip(layer, lst):
            bst, y = apply_one(b, bst, x[..., off:off + b.in_size])
            outs.append(y)
            nls.append(bst)
            off += b.in_size
        x = torch.cat(outs, dim=-1)
        new_state.append(nls)
    return new_state, x


def apply_xform_stateful(xf: Xform, st, x: torch.Tensor):
    """[..., T, in] chunk + carried state -> (state', [..., T, out])."""
    if xf.kind == "stacking":
        ctx, out = _stack(xf, st, x)
        return ctx[..., x.shape[-2]:, :], out
    if xf.kind == "composite":
        return _composite(xf, st, x, apply_xform_stateful)
    return st, apply_xform(xf, x)


def instance_init_state(inst: XformInstance, lead: Tuple[int, ...] = (),
                        device="cpu"):
    return ((instance_init_state(inst.input, lead, device)
             if inst.input is not None else None),
            xform_init_state(inst.xform, lead, device))


def apply_instance_stateful(inst: XformInstance, st, x: torch.Tensor):
    """Chunked XformInstance chain: (state, [..., T, D]) -> (state',
    [..., T, out])."""
    in_st, xf_st = st
    if inst.input is not None:
        in_st, x = apply_instance_stateful(inst.input, in_st, x)
    xf_st, y = apply_xform_stateful(inst.xform, xf_st, x)
    return (in_st, xf_st), y


def apply_xform_stateful_ragged(xf: Xform, st, x: torch.Tensor, n_valid):
    """apply_xform_stateful where only the first ``n_valid`` rows of each
    [T, in] slab of ``x`` are real frames (the multi-stream ragged block:
    valid rows lead, the rest are padding); ``n_valid`` has x's leading
    shape (an int for an unbatched x).  Each delay line advances by
    exactly its n_valid frames, by one gather over the batched states, so
    a stream idling through a block keeps its stacks; output rows >=
    n_valid are garbage (the caller masks them).  With n_valid == T this
    equals apply_xform_stateful."""
    if xf.kind == "stacking":
        ctx, out = _stack(xf, st, x)
        lead, K1 = x.shape[:-2], xf.stack_size - 1
        nv = torch.as_tensor(n_valid, device=x.device).to(torch.int64)
        idx = nv.reshape(*lead, 1) + torch.arange(K1, device=x.device)
        idx = idx[..., None].expand(*lead, K1, ctx.shape[-1])
        return torch.gather(ctx, -2, idx), out
    if xf.kind == "composite":
        return _composite(
            xf, st, x, lambda b, bst, y: apply_xform_stateful_ragged(
                b, bst, y, n_valid))
    return st, apply_xform(xf, x)


def apply_instance_stateful_ragged(inst: XformInstance, st, x: torch.Tensor,
                                   n_valid):
    in_st, xf_st = st
    if inst.input is not None:
        in_st, x = apply_instance_stateful_ragged(inst.input, in_st, x,
                                                  n_valid)
    xf_st, y = apply_xform_stateful_ragged(inst.xform, xf_st, x, n_valid)
    return (in_st, xf_st), y


class StreamingXform:
    """Stateful wrapper for a streaming path: feed chunks [..., T, D], get
    transformed chunks equal to the whole-utterance apply_instance."""

    def __init__(self, inst: XformInstance, lead: Tuple[int, ...] = (),
                 device="cuda"):
        self.inst = inst
        self.state = instance_init_state(inst, lead, device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        self.state, y = apply_instance_stateful(self.inst, self.state, x)
        return y
