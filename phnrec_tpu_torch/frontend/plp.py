"""PLP frontend on torch tensors (reference: plp.{cpp,h}, PLPCoefs :
MelBanks).

Counterpart of phnrec_tpu/frontend/plp.py; the matrices below are copied
from it (numpy, float64).  Per frame (plp.cpp:91-141): mel energies (no
log) -> floor 1.0 -> equal-loudness curve at the bank centres
(dspc.h:235-245) -> cube-root compression -> the edge banks duplicated ->
IDFT to autocorrelation (CreateIDFTMatrix, plp.cpp:143-167) -> Durbin's
recursion (dspc.cpp:275-308) -> LPC to cepstrum (dspc.cpp:310-323) -> C0 =
-ln(1/gain) appended last -> the lifter (dspc.cpp:327-335) -> the cepstral
scale.

The mel and IDFT steps are the frontend's GEMMs (float32, TF32 off where
SpeechRec builds); Durbin's recursion and the cepstrum have a small static
order (12), so they unroll into elementwise ops over all frames at once,
as in phnrec_tpu.  No kernel of phnrec_tpu computes this (it runs outside
any Pallas kernel), so plain torch ops are the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from phnrec_tpu_torch.frontend.melbanks import (MelFrontend, MelSpec,
                                                mel_scale, mel_to_linear)


def equal_loudness_curve(centers_hz: np.ndarray) -> np.ndarray:
    fsq = centers_hz.astype(np.float64) ** 2
    fsub = fsq / (fsq + 1.6e5)
    return fsub * fsub * ((fsq + 1.44e6) / (fsq + 9.61e6))


def idft_matrix(n_bases: int, dim: int) -> np.ndarray:
    """CreateIDFTMatrix (plp.cpp:143-167): [n_bases, dim]."""
    angle = np.pi / (dim - 1)
    scale = 1.0 / (2.0 * (dim - 1))
    i = np.arange(n_bases)[:, None].astype(np.float64)
    j = np.arange(dim)[None, :].astype(np.float64)
    m = 2.0 * scale * np.cos(angle * i * j)
    m[:, 0] = scale
    m[:, -1] = scale * np.cos(angle * i[:, 0] * (dim - 1))
    return m


def lifter_window(order: int, q: float) -> np.ndarray:
    i = np.arange(1, order + 1, dtype=np.float64)
    return 1.0 + 0.5 * q * np.sin(np.pi * i / q)


class PLPFrontend(nn.Module):
    """MelFrontend's interface, and ``n_params`` = order (+1 with C0)."""

    def __init__(self, spec: MelSpec, cfg=None, order: int = 12,
                 compress_fact: float = 0.3333333, cep_lifter: float = 22.0,
                 cep_scale: float = 10.0, add_c0: bool = False):
        super().__init__()
        if cfg is not None:
            order = cfg.get_int("plp", "order")
            compress_fact = cfg.get_float("plp", "compress_fact")
            cep_lifter = cfg.get_float("plp", "cep_lifter")
            cep_scale = cfg.get_float("plp", "cep_scale")
            add_c0 = cfg.get_bool("plp", "add_c0")
        self.spec = dataclasses.replace(spec, take_log=False)
        self.mel = MelFrontend(self.spec)
        self.order = order
        self.compress_fact = compress_fact
        self.cep_lifter = cep_lifter
        self.cep_scale = cep_scale
        self.add_c0 = add_c0

        nb = self.spec.nbanks
        lo = max(float(self.spec.lo_freq), 0.0)
        hi = min(float(self.spec.hi_freq), self.spec.sample_freq / 2.0)
        delta = (mel_scale(hi) - mel_scale(lo)) / (self.spec.full_banks + 1)
        centers = mel_to_linear(mel_scale(lo) + delta * np.arange(1, nb + 1))
        f32 = dict(dtype=torch.float32)
        self.register_buffer("eql", torch.tensor(
            equal_loudness_curve(centers), **f32))
        self.register_buffer("idft", torch.tensor(
            idft_matrix(order + 1, nb + 2).T, **f32))   # [nb + 2, order + 1]
        self.register_buffer("lifter", torch.tensor(
            lifter_window(order, cep_lifter), **f32))

    @property
    def n_params(self) -> int:
        return self.order + 1 if self.add_c0 else self.order

    def frame_count(self, n_samples: int) -> int:
        return self.mel.frame_count(n_samples)

    def frames_from_wave(self, wave: torch.Tensor,
                         num_frames: int) -> torch.Tensor:
        return self.mel.frames_from_wave(wave, num_frames)

    def log_mel_from_frames(self, frames: torch.Tensor) -> torch.Tensor:
        """(named as MelFrontend's) [..., vs] frames -> [..., n_params]
        PLP cepstra."""
        order = self.order
        e = torch.clamp(self.mel.log_mel_from_frames(frames), min=1.0)
        e = torch.pow(e * self.eql, float(np.float32(self.compress_fact)))
        e = torch.cat([e[..., :1], e, e[..., -1:]], dim=-1)
        ac = torch.matmul(e, self.idft)                 # [..., order + 1]

        # Durbin's recursion, unrolled over the static order
        E = ac[..., 0]
        lp = [torch.zeros_like(E) for _ in range(order)]
        for i in range(order):
            ki = ac[..., i + 1]
            for j in range(i):
                ki = ki + lp[j] * ac[..., i - j]
            ki = ki / E
            E = E * (1.0 - ki * ki)
            new_lp = [lp[j] - ki * lp[i - j - 1] for j in range(i)]
            new_lp.append(-ki)
            lp[: i + 1] = new_lp

        # LPC -> cepstrum
        cep = []
        for i in range(order):
            s = torch.zeros_like(E)
            for j in range(i):
                s = s + (i - j) * lp[j] * cep[i - j - 1]
            cep.append(-lp[i] - s / (i + 1))

        c0 = torch.log(E)                               # -ln(1/gain)
        cep = torch.stack(cep, dim=-1)
        if self.cep_lifter != 0.0:
            cep = cep * self.lifter
        out = torch.cat([cep, c0[..., None]], dim=-1)
        if self.cep_scale != 1.0:
            out = out * float(np.float32(self.cep_scale))
        return out if self.add_c0 else out[..., :order]

    def forward(self, wave: torch.Tensor, num_frames: int) -> torch.Tensor:
        return self.log_mel_from_frames(
            self.frames_from_wave(wave, num_frames))
