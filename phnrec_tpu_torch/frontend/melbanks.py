"""Mel-filterbank frontend as batched GEMMs on torch tensors.

Counterpart of phnrec_tpu/frontend/melbanks.py; the filter design and the
matrix folding below are copied from it (numpy, float64).  Reference
semantics (melbanks.cpp, dspc.cpp): per 25 ms frame with 10 ms hop
  [optional mean-subtract] -> [optional pre-emphasis] -> Hamming window ->
  zero-pad to next pow-2 -> radix-2 FFT -> power spectrum (|X|^2, no sqrt,
  dspc.cpp:141-146) -> triangular mel filterbank (_mbInit/_mbApply,
  dspc.cpp:80-269) -> ln with a >0 guard (dspc.h:155-160).

Every per-frame step is linear up to the power and the log, so the frontend
is two GEMMs:

  frames [T, vs] --(C = fold(zmean, preem, hamming) @ DFT)--> re/im [T, nfft/2]
  power = re^2 + im^2 --(mel matrix A [nfft/2, nbanks])--> energies [T, nbanks]
  params = ln(max(energies, tiny))

The GEMMs run in float32 (TF32 is switched off where SpeechRec builds).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
from torch import nn


@dataclass(frozen=True)
class MelSpec:
    """Static frontend configuration."""

    sample_freq: int = 8000
    vector_size: int = 200     # frame length in samples (25 ms)
    step: int = 80             # frame hop in samples (10 ms)
    nbanks: int = 15           # banks kept in the output
    nbanks_full: int = -1      # banks computed (-1 => nbanks), melbanks.h:81-82
    lo_freq: float = 64.0
    hi_freq: float = 4000.0
    preem_coef: float = 0.0
    z_mean: bool = False
    take_log: bool = True

    @property
    def full_banks(self) -> int:
        return self.nbanks if self.nbanks_full == -1 else self.nbanks_full

    @property
    def nfft(self) -> int:
        n = 1
        while n < self.vector_size:
            n *= 2
        return n


def mel_scale(f):
    return 1127.0 * np.log(1.0 + f / 700.0)


def mel_to_linear(m):
    return 700.0 * (np.exp(m / 1127.0) - 1.0)


def design_mel_filters(spec: MelSpec) -> Tuple[np.ndarray, int, int]:
    """Triangular filterbank exactly as _mbInit (dspc.cpp:80-225).

    Returns (A [nfft/2, full_banks] float64, fftlo, ffthi) where
    mel_energies = power_spectrum[0:nfft/2] @ A.  Centers are equally spaced
    in mel between lo and hi; each FFT bin i in [fftlo, ffthi] is assigned a
    channel ch and weight c, contributing c*power to bank ch-1 and
    (1-c)*power to bank ch (_mbApply, dspc.cpp:236-269).
    """
    count = spec.full_banks
    if count < 3:
        raise ValueError("number of mel filters must be > 3")
    lo = max(float(spec.lo_freq), 0.0)
    hi = min(float(spec.hi_freq), spec.sample_freq / 2.0)
    nfft = spec.nfft
    nfft_2 = nfft // 2
    bf = spec.sample_freq / nfft
    mlo, mhi = mel_scale(lo), mel_scale(hi)
    fftlo = int(lo / bf + 1.5)
    ffthi = int(hi / bf - 0.5)
    fftlo = max(fftlo, 1)
    ffthi = min(ffthi, nfft_2 - 1)

    delta = (mhi - mlo) / (count + 1)
    # centers f0m[0..count] start one delta above mlo (dspc.cpp:156-162)
    f0m = mlo + delta * np.arange(1, count + 2)

    A = np.zeros((nfft_2, count), dtype=np.float64)
    for i in range(fftlo, ffthi + 1):
        mf = mel_scale(i * bf)
        ch = int(np.searchsorted(f0m, mf, side="left"))
        # _mbInit advances while mel_freq > f0m[ch]; strictly-greater search
        while ch <= count and mf > f0m[ch]:
            ch += 1
        if ch == 0:
            coef = (f0m[0] - mf) / (f0m[0] - mlo)
        else:
            coef = (f0m[ch] - mf) / (f0m[ch] - f0m[ch - 1])
        if ch > 0:
            A[i, ch - 1] += coef
        if ch < count:
            A[i, ch] += 1.0 - coef
    return A, fftlo, ffthi


def hamming_window(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    return 0.54 - 0.46 * np.cos(2.0 * np.pi * i / (n - 1))


def _preemphasis_matrix(n: int, a: float) -> np.ndarray:
    """sPreemphasisBW as a linear operator (dspc.h:77-84):
    y[k] = x[k] - a*x[k-1] for k>0, y[0] = (1-a)*x[0]."""
    M = np.eye(n, dtype=np.float64)
    M[0, 0] = 1.0 - a
    for k in range(1, n):
        M[k, k - 1] = -a
    return M


def _zmean_matrix(n: int) -> np.ndarray:
    return np.eye(n, dtype=np.float64) - np.full((n, n), 1.0 / n)


def frontend_matrices(spec: MelSpec) -> Tuple[np.ndarray, np.ndarray]:
    """(C [vs, 2*nfft/2], A [nfft/2, full_banks]) in float64: the folded
    preprocess+DFT matrix, re|im stacked, and the mel filterbank
    (phnrec_tpu/frontend/melbanks.py:138-166)."""
    vs, nfft = spec.vector_size, spec.nfft
    nfft_2 = nfft // 2
    A, _, _ = design_mel_filters(spec)

    # frame preprocessing as one [vs, vs] operator
    P = np.eye(vs, dtype=np.float64)
    if spec.z_mean:
        P = _zmean_matrix(vs) @ P
    if spec.preem_coef != 0.0:
        P = _preemphasis_matrix(vs, spec.preem_coef) @ P
    P = np.diag(hamming_window(vs)) @ P

    # DFT (bins 0..nfft/2-1; cFour1 uses exp(-i 2 pi k n / N) with
    # isign=-1, dspc.cpp:24-78).  Only rows 0..vs-1 are nonzero because
    # frames are zero-padded to nfft.
    n = np.arange(vs, dtype=np.float64)[:, None]
    k = np.arange(nfft_2, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * n * k / nfft
    C = np.concatenate([P @ np.cos(ang), P @ np.sin(ang)], axis=1)
    return C, A


class MelFrontend(nn.Module):
    """The folded DFT and mel matrices as buffers, and the feature
    functions over [..., L] waveforms."""

    def __init__(self, spec: MelSpec):
        super().__init__()
        self.spec = spec
        C, A = frontend_matrices(spec)
        self.register_buffer("dft", torch.tensor(C, dtype=torch.float32))
        self.register_buffer("mel", torch.tensor(A, dtype=torch.float32))
        self.nfft_2 = spec.nfft // 2

    @property
    def n_params(self) -> int:
        return self.spec.nbanks

    def frame_count(self, n_samples: int) -> int:
        """srec.cpp:945: one frame minimum, else 1 + (L - vs) // step."""
        vs, st = self.spec.vector_size, self.spec.step
        return 1 if n_samples <= vs else (n_samples - vs) // st + 1

    def frame_indices(self, num_frames: int) -> torch.Tensor:
        """[num_frames, vs] sample indices of each frame."""
        vs, st = self.spec.vector_size, self.spec.step
        dev = self.dft.device
        return (torch.arange(num_frames, device=dev)[:, None] * st
                + torch.arange(vs, device=dev)[None, :])

    def frames_from_wave(self, wave: torch.Tensor,
                         num_frames: int) -> torch.Tensor:
        """[..., L] padded waveform -> [..., num_frames, vs].  Indices past
        the end clamp to the last sample, as JAX's gather does
        (phnrec_tpu/frontend/melbanks.py:186)."""
        vs, st = self.spec.vector_size, self.spec.step
        L = wave.shape[-1]
        if (num_frames - 1) * st + vs <= L:
            return wave.unfold(-1, vs, st)[..., :num_frames, :]
        idx = self.frame_indices(num_frames).to(wave.device)
        return wave[..., idx.clamp_(max=L - 1)]

    def log_mel_from_frames(self, frames: torch.Tensor) -> torch.Tensor:
        """[..., vs] frames -> [..., nbanks] log mel energies."""
        ri = torch.matmul(frames, self.dft)
        re, im = ri.split(self.nfft_2, dim=-1)
        power = re * re + im * im
        en = torch.matmul(power, self.mel)[..., : self.spec.nbanks]
        if self.spec.take_log:
            # sLn guard: ln(x) for x > 0 else 0 (dspc.h:155-160)
            en = torch.where(en > 0.0, torch.log(torch.clamp(en, min=1e-37)),
                             0.0)
        return en

    def forward(self, wave: torch.Tensor, num_frames: int) -> torch.Tensor:
        return self.log_mel_from_frames(
            self.frames_from_wave(wave, num_frames))


def spec_from_config(cfg) -> MelSpec:
    """Build a MelSpec from a PhnRecConfig (srec.cpp:549-561)."""
    return MelSpec(
        sample_freq=cfg.get_int("source", "sample_freq"),
        vector_size=cfg.get_int("melbanks", "vector_size"),
        step=cfg.get_int("melbanks", "vector_step"),
        nbanks=cfg.get_int("melbanks", "nbanks"),
        nbanks_full=cfg.get_int("melbanks", "nbanks_full"),
        lo_freq=cfg.get_float("melbanks", "lower_freq"),
        hi_freq=cfg.get_float("melbanks", "higher_freq"),
        preem_coef=cfg.get_float("melbanks", "preem_coef"),
        z_mean=cfg.get_bool("melbanks", "z_mean_source"),
    )
