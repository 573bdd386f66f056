"""The LCRC posterior estimator on torch tensors.

Counterpart of phnrec_tpu/posteriors/estimator.py:43-99 (LCRCEstimator),
the shipped system of the reference's Traps (traps.cpp):

    L, R   = LCRC assembly (stc.py)                 2 depthwise convs
    lo, ro = band MLPs (mlp.py)                     kernel A, twice
    m      = ln(concat(lo, ro))  (traps.cpp:435-461, sLn dspc.h:155-160)
    post   = merger MLP                             kernel A

Model-package file naming follows the reference conventions (config.h:30-39):
<dir>/weights/band{i}.weights(.nbin), <dir>/norms/band{i}.norms,
<dir>/windows/band{i}.window, <dir>/weights/merger.weights.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import torch
from torch import nn

from phnrec_tpu_torch.io.weights import load_net, load_window
from phnrec_tpu_torch.posteriors.mlp import MLP
from phnrec_tpu_torch.posteriors.stc import LCRCAssembler, LCRCSpec


def sln(m: torch.Tensor) -> torch.Tensor:
    """sLn guard: ln(x) for x > 0 else 0 (dspc.h:155-160)."""
    return torch.where(m > 0.0, torch.log(torch.clamp(m, min=1e-37)), 0.0)


class LCRCEstimator(nn.Module):
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


def build_estimator(system: str, model_dir: str, nbanks: int,
                    trap_len: int = 31, add_c0: bool = True,
                    use_hamming: bool = True, fast_exp: bool = True):
    """Traps::SetSystem (traps.cpp:572-586); the port covers LCRC."""
    if system == "LCRC":
        return LCRCEstimator(model_dir, nbanks=nbanks, trap_len=trap_len,
                             add_c0=add_c0, fast_exp=fast_exp)
    if system in ("3BT", "1BT", "1BT_DCT"):
        raise NotImplementedError(
            f"posterior system {system!r} is not ported yet "
            "(ROADMAP.md, Queue 1 item 11: TrapsEstimator, DCTEstimator)")
    raise ValueError(f"unknown posterior system {system!r} "
                     "(Traps::SetSystem accepts LCRC/3BT/1BT/1BT_DCT)")
