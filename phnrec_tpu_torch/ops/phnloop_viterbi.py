"""Kernel C: the phoneme-loop Viterbi scan (csrc/phnloop_viterbi.cu) and its
plain PyTorch version.

Counterpart of phnrec_tpu/decoder/phnloop.py::viterbi_block.  Layouts are
JAX's: carry [P, S+1, B] (alphas f32, entry frames i32), log_post
[B, T, D >= P*S], History [T, B] (i8, i32, f32).  Both versions are adds,
compares and first-index argmaxes, so their History is bit-equal to JAX's.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from phnrec_tpu_torch.ops import _build

LAUNCHES = 0

Carry = Tuple[torch.Tensor, torch.Tensor]
Hist = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def viterbi_block_plain(carry: Carry, log_post: torch.Tensor, t0: int,
                        n_phonemes: int, n_states: int, w_penalty: float,
                        tr_curr: float, tr_next: float
                        ) -> Tuple[Carry, Hist]:
    """The scan as a Python loop of torch ops over frames, on any device."""
    P, S = n_phonemes, n_states
    alphas, ent = carry
    B, T = log_post.shape[0], log_post.shape[1]
    dev = log_post.device
    f32 = torch.float32
    w_pen = torch.tensor(w_penalty, dtype=f32, device=dev)
    tr_c = torch.tensor(tr_curr, dtype=f32, device=dev)
    tr_n = torch.tensor(tr_next, dtype=f32, device=dev)
    obs = log_post[:, :, : P * S].reshape(B, T, P, S).permute(1, 2, 3, 0)
    h_phn = torch.empty((T, B), dtype=torch.int8, device=dev)
    h_ent = torch.empty((T, B), dtype=torch.int32, device=dev)
    h_alpha = torch.empty((T, B), dtype=f32, device=dev)
    for t in range(T):
        tok_cur = alphas[:, 1:, :] + tr_c            # self-loop
        tok_prev = alphas[:, :-1, :] + tr_n          # advance from s-1
        take_cur = tok_cur > tok_prev                # advance wins ties
        new_a = torch.where(take_cur, tok_cur, tok_prev) + obs[t]
        new_e = torch.where(take_cur, ent[:, 1:, :], ent[:, :-1, :])
        exit_a = new_a[:, -1, :]                     # [P, B]
        maxi = torch.argmax(exit_a, dim=0, keepdim=True)   # first max wins
        max_a = exit_a.gather(0, maxi)[0]
        h_phn[t] = maxi[0].to(torch.int8)
        h_ent[t] = new_e[:, -1, :].gather(0, maxi)[0]
        h_alpha[t] = max_a
        alphas = torch.cat([(max_a + w_pen).expand(P, 1, B), new_a], dim=1)
        ent = torch.cat([torch.full((P, 1, B), t0 + t + 1, dtype=torch.int32,
                                    device=dev), new_e], dim=1)
    return (alphas, ent), (h_phn, h_ent, h_alpha)


def _lib():
    lib = _build.load("phnloop_viterbi")
    fn = lib.phn_viterbi
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                       + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 6)
        fn.restype = ctypes.c_int
        lib.phn_viterbi_max_states.restype = ctypes.c_int
        lib.phn_viterbi_max_phonemes.restype = ctypes.c_int
    return lib


def viterbi_block(carry: Carry, log_post: torch.Tensor, t0: int,
                  n_phonemes: int, n_states: int, w_penalty: float,
                  tr_curr: float, tr_next: float) -> Tuple[Carry, Hist]:
    """One block of frames: CPU tensors take the plain version; CUDA
    tensors launch the kernel (one launch for all T frames), and anything
    the kernel does not take raises."""
    if log_post.device.type == "cpu":
        return viterbi_block_plain(carry, log_post, t0, n_phonemes, n_states,
                                   w_penalty, tr_curr, tr_next)
    device = _build.cuda_device(log_post)
    P, S = n_phonemes, n_states
    if log_post.dim() != 3:
        raise ValueError("log_post must be [B, T, D]")
    B, T, D = log_post.shape
    if D < P * S:
        raise ValueError(f"log_post has {D} columns, needs {P * S}")
    if B * max(T, 1) * D >= 2 ** 62 or T >= 2 ** 31:
        raise ValueError("log_post too large")
    alphas, ent = carry
    _build.require(log_post, "log_post", torch.float32, (B, T, D), device)
    _build.require(alphas, "carry alphas", torch.float32, (P, S + 1, B),
                   device)
    _build.require(ent, "carry ent", torch.int32, (P, S + 1, B), device)
    lib = _lib()
    if S > lib.phn_viterbi_max_states() or \
            P > lib.phn_viterbi_max_phonemes():
        raise ValueError(f"kernel takes at most "
                         f"{lib.phn_viterbi_max_phonemes()} phonemes of "
                         f"{lib.phn_viterbi_max_states()} states")
    out_a = torch.empty_like(alphas)
    out_e = torch.empty_like(ent)
    h_phn = torch.empty((T, B), dtype=torch.int8, device=device)
    h_ent = torch.empty((T, B), dtype=torch.int32, device=device)
    h_alpha = torch.empty((T, B), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.phn_viterbi(
            alphas.data_ptr(), ent.data_ptr(), log_post.data_ptr(),
            B, T, P, S, D, int(t0), w_penalty, tr_curr, tr_next,
            out_a.data_ptr(), out_e.data_ptr(), h_phn.data_ptr(),
            h_ent.data_ptr(), h_alpha.data_ptr(), stream)
    _build.check(err, "phnloop_viterbi")
    global LAUNCHES
    LAUNCHES += 1
    return (out_a, out_e), (h_phn, h_ent, h_alpha)
