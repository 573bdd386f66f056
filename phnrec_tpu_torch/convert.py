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
  (phnrec_tpu/decoder/stknet.py:309-357) -> the port's ``EdgeTables``;
* ``band_stack_from_jax``: a ``_BandStack`` (padded, stacked band nets,
  phnrec_tpu/posteriors/estimator.py:107-116) -> ``BandStack``;
* ``traps_from_jax`` / ``dct_from_jax``: a ``TrapsEstimator`` (3BT / 1BT)
  or ``DCTEstimator`` (1BT_DCT) -> the port's, its window or DCT matrix
  copied;
* ``plp_from_jax``: a ``PLPFrontend`` -> the port's, its equal-loudness,
  IDFT, lifter and mel matrices copied;
* ``accumulators_from_numpy``: training accumulators (any tuple with the
  fields of ``train.accum.Accumulators``) -> the port's, on ``device``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from phnrec_tpu_torch.decoder.stknet import DenseKWSScan, EdgeTables
from phnrec_tpu_torch.frontend.melbanks import MelFrontend, MelSpec
from phnrec_tpu_torch.frontend.plp import PLPFrontend
from phnrec_tpu_torch.io.weights import MLPParams
from phnrec_tpu_torch.posteriors.estimator import (BandStack, DCTEstimator,
                                                   TrapsEstimator)
from phnrec_tpu_torch.posteriors.mlp import MLP
from phnrec_tpu_torch.posteriors.stc import LCRCAssembler, LCRCSpec
from phnrec_tpu_torch.train.accum import Accumulators


def mlp_from_device(net) -> MLP:
    i, h, o = net.n_inp, net.n_hid, net.n_out
    a = {f: np.asarray(getattr(net, f))
         for f in ("w1", "b1", "w2", "b2", "mean", "dev")}
    return MLP(a["w1"][:i, :h], a["b1"][:h], a["w2"][:h, :o], a["b2"][:o],
               a["mean"][:i], a["dev"][:i])


def params_from_device(net) -> MLPParams:
    """An ``MLPDevice`` back in the on-disk layout (unpadded)."""
    i, h, o = net.n_inp, net.n_hid, net.n_out
    a = {f: np.asarray(getattr(net, f), np.float32)
         for f in ("w1", "b1", "w2", "b2", "mean", "dev")}
    return MLPParams(a["w1"][:i, :h].T, a["b1"][:h], a["w2"][:h, :o].T,
                     a["b2"][:o], a["mean"][:i], a["dev"][:i])


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


def _band_params(bands, n_inp: int):
    """The band nets of a ``_BandStack`` in the on-disk layout, sliced to
    ``n_inp`` inputs, ``bands.n_out`` outputs and the hidden units that
    carry anything (padded ones have zero weights and bias)."""
    a = {f: np.asarray(getattr(bands, f), np.float32)
         for f in ("w1", "b1", "w2", "b2", "mean", "dev")}
    live = np.nonzero(np.abs(a["w1"]).sum((0, 1)) + np.abs(a["b1"]).sum(0)
                      + np.abs(a["w2"]).sum((0, 2)))[0]
    h, o = int(live.max()) + 1, int(bands.n_out)
    return [MLPParams(a["w1"][b, :n_inp, :h].T, a["b1"][b, :h],
                      a["w2"][b, :h, :o].T, a["b2"][b, :o],
                      a["mean"][b, :n_inp], a["dev"][b, :n_inp])
            for b in range(a["w1"].shape[0])]


def band_stack_from_jax(bands, n_inp: int) -> BandStack:
    """``bands`` is any object with ``_BandStack``'s fields."""
    return BandStack([mlp_from_params(p) for p in _band_params(bands, n_inp)])


def traps_from_jax(est) -> TrapsEstimator:
    """``est`` is any object with TrapsEstimator's ``bands``,
    ``trap_bands``, ``trap_len``, ``merger`` and ``window``."""
    out = TrapsEstimator(
        "", nbanks=int(est.trap_bands), system="1BT",
        trap_len=int(est.trap_len), fast_exp=bool(est.fast_exp),
        band_nets=_band_params(est.bands, int(est.trap_len)),
        merger=params_from_device(est.merger))
    out.window.copy_(torch.tensor(np.asarray(est.window, np.float32)))
    return out


def dct_from_jax(est) -> DCTEstimator:
    """``est`` is any object with DCTEstimator's ``merger``, ``m_dct``
    ([trap_len, n_coefs]) and ``trap_len``."""
    m_dct = np.asarray(est.m_dct, np.float32)
    merger = params_from_device(est.merger)
    out = DCTEstimator("", nbanks=merger.w1.shape[1] // m_dct.shape[1],
                       trap_len=int(est.trap_len),
                       fast_exp=bool(est.fast_exp), merger=merger)
    out.m_dct.copy_(torch.tensor(m_dct))
    return out


def plp_from_jax(fe) -> PLPFrontend:
    """``fe`` is any object with PLPFrontend's spec, settings and matrices
    (``eql``, ``idft``, ``lifter``, and ``mel.dft`` / ``mel.mel``)."""
    mel = frontend_from_matrices(fe.spec, fe.mel.dft, fe.mel.mel)
    out = PLPFrontend(mel.spec, order=int(fe.order),
                      compress_fact=float(fe.compress_fact),
                      cep_lifter=float(fe.cep_lifter),
                      cep_scale=float(fe.cep_scale), add_c0=bool(fe.add_c0))
    out.mel = mel
    for name in ("eql", "idft", "lifter"):
        getattr(out, name).copy_(torch.tensor(
            np.asarray(getattr(fe, name), np.float32)))
    return out


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


def accumulators_from_numpy(acc, device="cpu") -> Accumulators:
    """phnrec_tpu's ``Accumulators`` (or any tuple with its fields, as
    array-likes) -> the port's, float32 tensors on ``device``."""
    return Accumulators(*(
        None if getattr(acc, name) is None else torch.as_tensor(
            np.array(getattr(acc, name), np.float32), device=device)
        for name in Accumulators._fields))
