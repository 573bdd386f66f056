"""Carry phnrec_tpu's parameters, given as numpy arrays, into the port.

Takes duck-typed objects (any array-likes ``np.asarray`` accepts), so the
port never imports JAX or phnrec_tpu:

* ``mlp_from_device``: a phnrec_tpu ``MLPDevice`` (padded and transposed,
  phnrec_tpu/posteriors/mlp.py:42-88) -> ``MLP``, sliced back to
  n_inp/n_hid/n_out;
* ``mlp_from_params``: an ``MLPParams`` (the on-disk layout) -> ``MLP``;
* ``lcrc_from_taps``: an LCRC spec and its ``m_left``/``m_right`` taps ->
  ``LCRCAssembler``;
* ``frontend_from_matrices``: a ``MelSpec`` and its ``dft``/``mel``
  matrices -> ``MelFrontend``;
* ``dense_kws_from_jax``: a ``DenseKWSScan``'s tables (``A_in``, ``A_ex``,
  ``A_cm``, ``R_cm``, ``A_cs``, ``_entry0``, the edge ids ``I_in``,
  ``I_ex``, ``I_cm``, ``I_cs`` and ``_entry_edge0``,
  phnrec_tpu/decoder/stknet.py:833-906) -> the port's ``DenseKWSScan``;
* ``network_tables_from_jax``: a ``NetworkDecoder``'s edge arrays
  (phnrec_tpu/decoder/stknet.py:309-357) -> the port's ``EdgeTables``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from phnrec_tpu_torch.decoder.stknet import DenseKWSScan, EdgeTables
from phnrec_tpu_torch.frontend.melbanks import MelFrontend, MelSpec
from phnrec_tpu_torch.posteriors.mlp import MLP
from phnrec_tpu_torch.posteriors.stc import LCRCAssembler, LCRCSpec


def mlp_from_device(net) -> MLP:
    i, h, o = net.n_inp, net.n_hid, net.n_out
    a = {f: np.asarray(getattr(net, f))
         for f in ("w1", "b1", "w2", "b2", "mean", "dev")}
    return MLP(a["w1"][:i, :h], a["b1"][:h], a["w2"][:h, :o], a["b2"][:o],
               a["mean"][:i], a["dev"][:i])


def mlp_from_params(p) -> MLP:
    return MLP(np.asarray(p.w1).T, np.asarray(p.b1), np.asarray(p.w2).T,
               np.asarray(p.b2), np.asarray(p.mean), np.asarray(p.dev))


def lcrc_from_taps(spec, m_left, m_right) -> LCRCAssembler:
    """``spec`` is any (nbanks, trap_len, n_coefs, add_c0) sequence."""
    spec = LCRCSpec(*spec)
    hc = (spec.trap_len - 1) // 2 + 1
    asm = LCRCAssembler(spec, np.ones(hc), np.ones(hc))
    asm.m_left.copy_(torch.tensor(np.asarray(m_left, np.float32)))
    asm.m_right.copy_(torch.tensor(np.asarray(m_right, np.float32)))
    return asm


def frontend_from_matrices(spec, dft, mel) -> MelFrontend:
    """``spec`` is any dataclass with MelSpec's fields."""
    fields = {f.name: getattr(spec, f.name)
              for f in dataclasses.fields(MelSpec)}
    fe = MelFrontend(MelSpec(**fields))
    fe.dft.copy_(torch.tensor(np.asarray(dft, np.float32)))
    fe.mel.copy_(torch.tensor(np.asarray(mel, np.float32)))
    return fe


def dense_kws_from_jax(dense) -> DenseKWSScan:
    """``dense`` is any object with DenseKWSScan's table attributes."""
    return DenseKWSScan.from_tables(
        *(np.asarray(getattr(dense, k)) for k in (
            "A_in", "A_ex", "A_cm", "R_cm", "A_cs", "_entry0")),
        n_sinks=int(dense.n_sinks),
        ids=tuple(np.asarray(getattr(dense, k)) for k in (
            "I_in", "I_ex", "I_cm", "I_cs")),
        entry_edge0=np.asarray(dense._entry_edge0))


def network_tables_from_jax(nd) -> EdgeTables:
    """``nd`` is any object with NetworkDecoder's edge arrays (``in_src``,
    ``in_entry``, ``in_w``, ``ex_*``, ``cm_*``, ``cs_*``, the four dense
    tables; ``cs_dense`` None when no closure edge ends in a sink) and
    its ``c.n_states`` / ``c.n_models`` / ``n_sinks``."""
    i32 = lambda k: np.asarray(getattr(nd, k), np.int32)  # noqa: E731
    f32 = lambda k: np.asarray(getattr(nd, k), np.float32)  # noqa: E731
    n_sinks = int(nd.n_sinks)
    cs_dense = (np.full((n_sinks, 1), -1, np.int32) if nd.cs_dense is None
                else i32("cs_dense"))
    return EdgeTables(
        n_states=int(nd.c.n_states), n_models=int(nd.c.n_models),
        n_sinks=n_sinks, in_src=i32("in_src"),
        in_entry=np.asarray(nd.in_entry, bool), in_w=f32("in_w"),
        in_dense=i32("in_dense"), ex_src=i32("ex_src"), ex_w=f32("ex_w"),
        ex_dense=i32("ex_dense"), cm_src=i32("cm_src"), cm_w=f32("cm_w"),
        cm_reset=np.asarray(nd.cm_reset, bool), cm_dense=i32("cm_dense"),
        cs_src=i32("cs_src"), cs_w=f32("cs_w"), cs_dense=cs_dense)
