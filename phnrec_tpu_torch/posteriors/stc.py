"""Split-temporal-context (LCRC) feature assembly as two depthwise convs,
and the clamped sliding context of the other posterior systems.

Counterpart of phnrec_tpu/posteriors/stc.py (``LCRCAssembler`` and
``clamped_context``).
Reference semantics (traps.cpp:285-342): a 31-frame sliding band-energy
window, initialized by replicating the first mel frame (traps.cpp:186-199);
left context = window columns 0..15, right context = columns 15..30; each
multiplied bankwise by its window file, then reduced per bank to
[C0, DCT_1..DCT_10] (dspc.h:206-233); features laid out bank-major.

feat[t, g, k] = sum_j p3[t + off + j, g] * M[j, k] is a length-16 temporal
cross-correlation per bank, so each side is one ``F.conv1d`` with
``groups=nbanks`` and output channel ``g * n_coefs + k``, the reference's
bank-major layout.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def dct_c0_matrix(n: int, n_coefs: int, add_c0: bool) -> np.ndarray:
    """[n, n_coefs] matrix M with columns = [C0?, DCT_1, DCT_2, ...].
    Copy of phnrec_tpu/posteriors/stc.py::dct_c0_matrix."""
    norm = np.sqrt(2.0 / n)
    j = np.arange(n, dtype=np.float64)
    cols = []
    n_dct = n_coefs - 1 if add_c0 else n_coefs
    if add_c0:
        cols.append(np.full(n, norm))
    for k in range(1, n_dct + 1):
        cols.append(norm * np.cos(np.pi / n * k * (j + 0.5)))
    return np.stack(cols, axis=1)


def clamped_context(params: torch.Tensor, trap_len: int,
                    n_valid=None) -> torch.Tensor:
    """[..., T, B] params (a leading utterance axis or none) -> [..., T,
    trap_len, B] sliding context, row t covering frames t-shift..t+shift
    with both edges clamped (the replicate-first-frame window init,
    traps.cpp:186-199, and the orchestrator's edge handling,
    srec.cpp:1035-1059).  Rows at or beyond ``n_valid`` ([...] valid
    counts) first repeat row n_valid-1 (the repeat-last-frame tail,
    srec.cpp:877-927).  Copies only: equal to phnrec_tpu's bit for bit
    (phnrec_tpu/posteriors/stc.py:52-75, vmapped there over utterances)."""
    T, nb = params.shape[-2:]
    shift = (trap_len - 1) // 2
    p = params
    if n_valid is not None:
        n_valid = torch.as_tensor(n_valid, device=p.device)
        last_idx = torch.clamp(n_valid.long() - 1, min=0)
        last = torch.take_along_dim(
            p, last_idx[..., None, None].expand(*last_idx.shape, 1, nb),
            dim=-2)                                      # [..., 1, B]
        mask = torch.arange(T, device=p.device) < n_valid[..., None]
        p = torch.where(mask[..., None], p, last)
    lead = p.shape[:-2]
    p3 = torch.cat([p[..., :1, :].expand(*lead, shift, nb), p,
                    p[..., -1:, :].expand(*lead, shift, nb)], dim=-2)
    # [..., T, B, trap_len] windows -> [..., T, trap_len, B]
    return p3.unfold(-2, trap_len, 1).transpose(-1, -2)


class LCRCSpec(NamedTuple):
    nbanks: int
    trap_len: int          # 31
    n_coefs: int           # band-net input size / nbanks (11 with add_c0)
    add_c0: bool


class LCRCAssembler(nn.Module):
    """The window*DCT taps of both context sides as registered buffers."""

    def __init__(self, spec: LCRCSpec, win_left: np.ndarray,
                 win_right: np.ndarray):
        super().__init__()
        self.spec = spec
        hc = (spec.trap_len - 1) // 2 + 1   # 16
        self.half_context = hc
        if win_left.shape[0] != hc or win_right.shape[0] != hc:
            raise ValueError("window length must equal half_context")
        M = dct_c0_matrix(hc, spec.n_coefs, spec.add_c0)  # [16, n_coefs]
        self.register_buffer("m_left", torch.tensor(
            win_left[:, None] * M, dtype=torch.float32))
        self.register_buffer("m_right", torch.tensor(
            win_right[:, None] * M, dtype=torch.float32))

    def context_indices(self, num_frames: int) -> torch.Tensor:
        """[T, trap_len] clip-gather indices: row t covers t-15..t+15."""
        shift = (self.spec.trap_len - 1) // 2
        dev = self.m_left.device
        t = torch.arange(num_frames, device=dev)[:, None]
        j = torch.arange(self.spec.trap_len, device=dev)[None, :]
        return torch.clamp(t + j - shift, 0, num_frames - 1)

    def context(self, params: torch.Tensor,
                n_valid=None) -> torch.Tensor:
        """[T, nbanks] mel params -> [T, trap_len, nbanks] clamped sliding
        context, rows from ``n_valid`` on repeating row n_valid-1."""
        return clamped_context(params, self.spec.trap_len, n_valid)

    def forward(self, params: torch.Tensor, n_valid=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[T, nbanks] mel params (+ the valid count of a padded
        utterance) -> (left, right) band-net inputs [T, nbanks*n_coefs]
        each: ``batched`` on one row."""
        n = None if n_valid is None else torch.as_tensor(
            n_valid, device=params.device).reshape(1)
        left, right = self.batched(params[None], n)
        return left[0], right[0]

    def _taps(self, m: torch.Tensor) -> torch.Tensor:
        # [hc, C] -> conv1d weight [nb*C, 1, hc]: output channel g*C + k
        # correlates bank g with column k of m
        return m.t().repeat(self.spec.nbanks, 1)[:, None, :].contiguous()

    def batched(self, params: torch.Tensor,
                n_valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, T, nbanks] mel params (+ [B] valid counts) -> (left, right)
        band-net inputs [B, T, nbanks*n_coefs].  Rows at or beyond
        n_valid repeat row n_valid-1 (the repeat-last-frame tail,
        srec.cpp:877-927); both edges are then replicated by 15 rows."""
        B, T, nb = params.shape
        shift = (self.spec.trap_len - 1) // 2
        p = params
        if n_valid is not None:
            n_valid = n_valid.to(p.device)
            last_idx = torch.clamp(n_valid.long() - 1, min=0)
            last = p[torch.arange(B, device=p.device), last_idx]
            mask = (torch.arange(T, device=p.device)[None, :]
                    < n_valid[:, None])[..., None]
            p = torch.where(mask, p, last[:, None, :])
        p3 = torch.cat([p[:, :1].expand(B, shift, nb), p,
                        p[:, -1:].expand(B, shift, nb)], dim=1)
        x = p3.transpose(1, 2)                     # [B, nb, T + 2*shift]
        hc = self.half_context

        def side(xs, m):
            y = F.conv1d(xs, self._taps(m), groups=nb)   # [B, nb*C, T]
            return y.transpose(1, 2)

        # left covers context cols 0..15 (p3 rows t..t+15), right cols
        # 15..30 (p3 rows t+15..t+30)
        return (side(x[:, :, : T + hc - 1], self.m_left),
                side(x[:, :, shift:], self.m_right))
