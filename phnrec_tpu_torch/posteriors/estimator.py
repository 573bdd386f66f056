"""The four posterior systems of the reference's Traps on torch tensors.

Counterpart of phnrec_tpu/posteriors/estimator.py (traps.cpp:572-586):

  * LCRC (the shipped system, LCRCEstimator):
        L, R   = LCRC assembly (stc.py)             2 depthwise convs
        lo, ro = band MLPs (mlp.py)                 kernel A, twice
        m      = ln(concat(lo, ro))  (traps.cpp:435-461, sLn dspc.h:155-160)
        post   = merger MLP                         kernel A
  * 3BT / 1BT (TrapsEstimator): one temporal-trap net per mel band (3BT
    skips the top two, traps.cpp:97-99) on the band's Hamming-windowed
    trajectory (traps.cpp:227-258), all of them one launch of kernel A
    with a band index (BandStack); the merger input is the band-major
    concatenation of their outputs through MINUS ln (traps.cpp:420-427);
    the merger is kernel A, past 480 inputs on its split path.
  * 1BT_DCT (DCTEstimator): no band nets; each band's windowed trajectory
    reduces to [C0?, DCT_1..] (the window folded into the DCT matrix)
    straight into the merger, with no ln (traps.cpp:260-281, 429-431).

Kernel A or A' by the precision mode (precision.py), as everywhere.
``posteriors_batched`` takes a padded batch [B, T, nbanks]; ``posteriors``
one utterance [T, nbanks], as a row of it.

Model-package file naming follows the reference conventions (config.h:30-39):
<dir>/weights/band{i}.weights(.nbin), <dir>/norms/band{i}.norms,
<dir>/windows/band{i}.window (LCRC only), <dir>/weights/merger.weights.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from phnrec_tpu_torch import precision
from phnrec_tpu_torch.io.weights import MLPParams, load_net, load_window
from phnrec_tpu_torch.ops import mlp_bf16x3, mlp_fused
from phnrec_tpu_torch.posteriors.mlp import MLP
from phnrec_tpu_torch.posteriors.stc import (LCRCAssembler, LCRCSpec,
                                             clamped_context, dct_c0_matrix)


def sln(m: torch.Tensor) -> torch.Tensor:
    """sLn guard: ln(x) for x > 0 else 0 (dspc.h:155-160)."""
    return torch.where(m > 0.0, torch.log(torch.clamp(m, min=1e-37)), 0.0)


class _Estimator(nn.Module):
    """What the three systems share: one utterance's posteriors as a row
    of their batched form."""

    def posteriors(self, params) -> torch.Tensor:
        """[T, nbanks] normalized mel params -> [T, n_out] posteriors:
        ``posteriors_batched`` of the utterance alone, so through the same
        kernels, bit for bit."""
        params = torch.as_tensor(params, dtype=torch.float32,
                                 device=self.merger.w1.device)
        n = torch.full((1,), params.shape[0], dtype=torch.int32,
                       device=params.device)
        return self.posteriors_batched(params[None], n)[0]


class LCRCEstimator(_Estimator):
    """One model package's band and merger nets and its LCRC taps."""

    def __init__(self, model_dir: str, nbanks: int, trap_len: int = 31,
                 add_c0: bool = True, fast_exp: bool = True):
        super().__init__()
        w = os.path.join(model_dir, "weights")
        n = os.path.join(model_dir, "norms")
        win = os.path.join(model_dir, "windows")
        half_context = (trap_len - 1) // 2 + 1
        self.trap_shift = (trap_len - 1) // 2   # frames of context a side

        self.band = nn.ModuleList([
            MLP.from_params(load_net(os.path.join(w, f"band{i}.weights"),
                                     os.path.join(n, f"band{i}.norms")))
            for i in range(2)
        ])
        self.merger = MLP.from_params(
            load_net(os.path.join(w, "merger.weights"),
                     os.path.join(n, "merger.norms")))

        if self.band[0].n_inp % nbanks != 0:
            raise ValueError(
                f"band net input {self.band[0].n_inp} not divisible by "
                f"nbanks {nbanks}")
        n_coefs = self.band[0].n_inp // nbanks
        spec = LCRCSpec(nbanks=nbanks, trap_len=trap_len, n_coefs=n_coefs,
                        add_c0=add_c0)
        self.assembler = LCRCAssembler(
            spec,
            load_window(os.path.join(win, "band0.window"), half_context),
            load_window(os.path.join(win, "band1.window"), half_context),
        )
        self.fast_exp = fast_exp

    def posteriors_batched(self, params: torch.Tensor,
                           n_frames: torch.Tensor, plain: bool = False,
                           mark: Optional[Callable[[str], None]] = None
                           ) -> torch.Tensor:
        """[B, T, nbanks] (+ [B] valid counts) -> [B, T, n_out].
        ``plain`` runs the MLPs' plain version (the reference run);
        ``mark`` is called with a stage name after each stage."""
        mark = mark or (lambda stage: None)
        left, right = self.assembler.batched(params, n_frames)
        mark("lcrc")
        lo = self.band[0](left, self.fast_exp, plain=plain)
        mark("band0_mlp")
        ro = self.band[1](right, self.fast_exp, plain=plain)
        mark("band1_mlp")
        m = sln(torch.cat([lo, ro], dim=-1))
        out = self.merger(m, self.fast_exp, plain=plain)
        mark("merger_mlp")
        return out


def hamming_window(n: int) -> np.ndarray:
    """0.54 - 0.46 cos(2 pi i / (n-1)) (sWindow_Hamming, dspc.h:162-167)."""
    i = np.arange(n, dtype=np.float64)
    return (0.54 - 0.46 * np.cos(2.0 * np.pi * i / (n - 1))).astype(
        np.float32)


def _no_marks(stage: str) -> None:
    pass


class BandStack(nn.Module):
    """``trap_bands`` band nets of one topology, their parameters stacked
    on a leading axis (phnrec_tpu's ``_BandStack``): w1 [NB, n_inp,
    n_hid], b1 [NB, n_hid], w2 [NB, n_hid, n_out], b2 [NB, n_out], mean
    and dev [NB, n_inp], and kernel A''s split weights net by net.  The
    stack runs as one launch of the band-indexed kernel A or A′."""

    def __init__(self, nets: Sequence[MLP]):
        super().__init__()
        shapes = {(m.n_inp, m.n_hid, m.n_out) for m in nets}
        if len(shapes) != 1:
            raise ValueError("band nets must share one topology to stack")
        self.n_inp, self.n_hid, self.n_out = shapes.pop()
        self.n_bands = len(nets)
        for name in ("w1", "b1", "w2", "b2", "mean", "dev"):
            self.register_buffer(name, torch.stack(
                [getattr(m, name) for m in nets]))
        for name in ("w1_hi", "w1_lo", "w2_hi", "w2_lo"):
            self.register_buffer(name, torch.stack(
                [getattr(m, name) for m in nets]), persistent=False)

    def forward(self, x: torch.Tensor, fast: bool = True,
                plain: bool = False) -> torch.Tensor:
        """[NB, N, n_inp] -> [NB, N, n_out] posteriors, each band through
        its own net."""
        x = x.contiguous()
        passes = precision.mlp_passes()
        if passes:
            fn = (mlp_bf16x3.mlp_forward_bf16x3_bands_plain if plain
                  else mlp_bf16x3.mlp_forward_bf16x3_bands)
            return fn(x, self.mean, self.dev, self.w1_hi, self.w1_lo,
                      self.b1, self.w2_hi, self.w2_lo, self.b2, fast=fast,
                      passes=passes)
        fn = (mlp_fused.mlp_forward_bands_plain if plain
              else mlp_fused.mlp_forward_bands)
        return fn(x, self.mean, self.dev, self.w1, self.b1, self.w2,
                  self.b2, fast=fast)


def _merger_params(model_dir: str) -> MLPParams:
    return load_net(os.path.join(model_dir, "weights", "merger.weights"),
                    os.path.join(model_dir, "norms", "merger.norms"))


class TrapsEstimator(_Estimator):
    """3BT / 1BT: per-band temporal-trap nets (traps.cpp:246-258).  Each
    band net's input size equals trap_len (the reference copies trap_len
    floats a frame at stride trap_len into the net's input,
    traps.cpp:252-257); 3BT drops the top two bands (trap_bands = nbanks
    - 2, traps.cpp:97-99).  ``band_nets`` and ``merger``, MLPParams in the
    on-disk layout, replace the package's files."""

    def __init__(self, model_dir: str, nbanks: int, system: str = "1BT",
                 trap_len: int = 31, use_hamming: bool = True,
                 fast_exp: bool = True, band_nets=None, merger=None):
        super().__init__()
        if system not in ("3BT", "1BT"):
            raise ValueError(f"TrapsEstimator does not cover {system!r}")
        self.trap_bands = nbanks - 2 if system == "3BT" else nbanks
        self.trap_len = trap_len
        if band_nets is None:
            w = os.path.join(model_dir, "weights")
            n = os.path.join(model_dir, "norms")
            band_nets = [load_net(os.path.join(w, f"band{i}.weights"),
                                  os.path.join(n, f"band{i}.norms"))
                         for i in range(self.trap_bands)]
        nets = [MLP.from_params(p) for p in band_nets]
        if any(m.n_inp != trap_len for m in nets):
            raise ValueError("band-net input size must equal trap length "
                             f"({trap_len}) for {system}")
        self.bands = BandStack(nets)
        self.merger = MLP.from_params(
            _merger_params(model_dir) if merger is None else merger)
        if self.merger.n_inp != self.trap_bands * self.bands.n_out:
            raise ValueError(
                f"merger input {self.merger.n_inp} != trap_bands "
                f"{self.trap_bands} x band outputs {self.bands.n_out}")
        self.register_buffer("window", torch.tensor(
            hamming_window(trap_len) if use_hamming
            else np.ones(trap_len, np.float32)))
        self.fast_exp = fast_exp
        self.trap_shift = (trap_len - 1) // 2

    def merger_input(self, ctx: torch.Tensor,
                     plain: bool = False) -> torch.Tensor:
        """[..., trap_len, nbanks] context -> [..., NB * band_out] merger
        input: the bands' windowed trajectories through the band stack,
        band-major a frame (traps.cpp:420-425), then minus ln (the sLn
        guard negated, traps.cpp:426-427)."""
        lead = ctx.shape[:-2]
        nb = self.trap_bands
        x = ctx.reshape(-1, self.trap_len, ctx.shape[-1])[..., :nb]
        x = x.permute(2, 0, 1) * self.window            # [NB, rows, trap_len]
        o = self.bands(x, self.fast_exp, plain=plain)   # [NB, rows, n_out]
        m = o.permute(1, 0, 2).reshape(*lead, nb * self.bands.n_out)
        return -sln(m)

    def posteriors_batched(self, params: torch.Tensor,
                           n_frames: torch.Tensor, plain: bool = False,
                           mark: Optional[Callable[[str], None]] = None
                           ) -> torch.Tensor:
        """[B, T, nbanks] (+ [B] valid counts) -> [B, T, n_out]; as the
        LCRC estimator's (``plain``, ``mark``)."""
        mark = mark or _no_marks
        ctx = clamped_context(params, self.trap_len, n_frames)
        mark("context")
        m = self.merger_input(ctx, plain)
        mark("band_mlp")
        out = self.merger(m, self.fast_exp, plain=plain)
        mark("merger_mlp")
        return out


class DCTEstimator(_Estimator):
    """1BT_DCT: each band's [C0?, DCT] of its (optionally Hamming-windowed)
    trajectory feeds the merger directly (traps.cpp:260-281); no band
    nets, no ln.  The window is folded into one [trap_len, n_coefs] matrix
    shared by every band."""

    def __init__(self, model_dir: str, nbanks: int, trap_len: int = 31,
                 add_c0: bool = False, use_hamming: bool = True,
                 fast_exp: bool = True, merger=None):
        super().__init__()
        self.merger = MLP.from_params(
            _merger_params(model_dir) if merger is None else merger)
        if self.merger.n_inp % nbanks != 0:
            raise ValueError(
                f"merger input {self.merger.n_inp} not divisible by "
                f"nbanks {nbanks}")
        n_coefs = self.merger.n_inp // nbanks
        self.trap_len = trap_len
        win = (hamming_window(trap_len) if use_hamming
               else np.ones(trap_len, np.float32))
        self.register_buffer("m_dct", torch.tensor(
            win[:, None] * dct_c0_matrix(trap_len, n_coefs, add_c0),
            dtype=torch.float32))
        self.fast_exp = fast_exp
        self.trap_shift = (trap_len - 1) // 2

    def merger_input(self, ctx: torch.Tensor,
                     plain: bool = False) -> torch.Tensor:
        """[..., trap_len, nbanks] -> [..., nbanks * n_coefs], bank-major."""
        feat = torch.matmul(ctx.transpose(-1, -2), self.m_dct)
        return feat.reshape(*feat.shape[:-2], -1)

    def posteriors_batched(self, params: torch.Tensor,
                           n_frames: torch.Tensor, plain: bool = False,
                           mark: Optional[Callable[[str], None]] = None
                           ) -> torch.Tensor:
        """[B, T, nbanks] (+ [B] valid counts) -> [B, T, n_out]."""
        mark = mark or _no_marks
        m = self.merger_input(clamped_context(params, self.trap_len,
                                              n_frames))
        mark("context")
        out = self.merger(m, self.fast_exp, plain=plain)
        mark("merger_mlp")
        return out


def build_estimator(system: str, model_dir: str, nbanks: int,
                    trap_len: int = 31, add_c0: bool = True,
                    use_hamming: bool = True, fast_exp: bool = True):
    """Traps::SetSystem (traps.cpp:572-586): LCRC | 3BT | 1BT | 1BT_DCT."""
    if system == "LCRC":
        return LCRCEstimator(model_dir, nbanks=nbanks, trap_len=trap_len,
                             add_c0=add_c0, fast_exp=fast_exp)
    if system in ("3BT", "1BT"):
        return TrapsEstimator(model_dir, nbanks=nbanks, system=system,
                              trap_len=trap_len, use_hamming=use_hamming,
                              fast_exp=fast_exp)
    if system == "1BT_DCT":
        return DCTEstimator(model_dir, nbanks=nbanks, trap_len=trap_len,
                            add_c0=add_c0, use_hamming=use_hamming,
                            fast_exp=fast_exp)
    raise ValueError(f"unknown posterior system {system!r} "
                     "(Traps::SetSystem accepts LCRC/3BT/1BT/1BT_DCT)")
