"""Kernels C and C': the phoneme-loop Viterbi scan (csrc/phnloop_viterbi.cu)
and its ragged multi-stream form, each with its plain PyTorch version and
its own launch count.

Counterparts of phnrec_tpu/decoder/phnloop.py::viterbi_block (C) and
::viterbi_block_ragged (C': per-row t0[b] and n_valid[b]; frames past
n_valid[b] leave row b's carry as it was, and its History rows there are
undefined).  Layouts are JAX's: carry [P, S+1, B] (alphas f32, entry frames
i32), log_post [B, T, D >= P*S], History [T, B] (i8, i32, f32).  Both
versions are adds, compares and first-index argmaxes, so their carry and
valid History are bit-equal to JAX's.  The kernel takes any S and any
D >= P*S (templates up to 5 states and one ring stage's row, a run-time-S
kernel past them) and P <= 128: the History's winner is int8, as JAX's is,
which wraps to -128 at phoneme 128 (the plain version wraps the same way);
the kernel refuses such a loop instead.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from phnrec_tpu_torch.ops import _build

LAUNCHES = 0           # kernel C
RAGGED_LAUNCHES = 0    # kernel C'

Carry = Tuple[torch.Tensor, torch.Tensor]
Hist = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _setup(log_post, n_phonemes, n_states, w_penalty, tr_curr, tr_next):
    """Frame-major observations [T, P, S, B], empty History [T, B], and
    the scalars as float32 tensors."""
    P, S = n_phonemes, n_states
    B, T = log_post.shape[0], log_post.shape[1]
    dev = log_post.device
    f32 = torch.float32
    obs = log_post[:, :, : P * S].reshape(B, T, P, S).permute(1, 2, 3, 0)
    hist = (torch.empty((T, B), dtype=torch.int8, device=dev),
            torch.empty((T, B), dtype=torch.int32, device=dev),
            torch.empty((T, B), dtype=f32, device=dev))
    scalars = tuple(torch.tensor(v, dtype=f32, device=dev)
                    for v in (w_penalty, tr_curr, tr_next))
    return obs, hist, scalars


def _step(alphas, ent, obs_t, t_next, w_pen, tr_c, tr_n):
    """One frame of the scan -> (alphas', ent', (winner, its entry frame,
    the max)); ``t_next`` (an int or a [B] tensor) is the global index of
    the next frame, the new entry column's frame."""
    P, B = alphas.shape[0], alphas.shape[2]
    tok_cur = alphas[:, 1:, :] + tr_c            # self-loop
    tok_prev = alphas[:, :-1, :] + tr_n          # advance from s-1
    take_cur = tok_cur > tok_prev                # advance wins ties
    new_a = torch.where(take_cur, tok_cur, tok_prev) + obs_t
    new_e = torch.where(take_cur, ent[:, 1:, :], ent[:, :-1, :])
    exit_a = new_a[:, -1, :]                     # [P, B]
    maxi = torch.argmax(exit_a, dim=0, keepdim=True)   # first max wins
    max_a = exit_a.gather(0, maxi)[0]
    rec = (maxi[0].to(torch.int8), new_e[:, -1, :].gather(0, maxi)[0], max_a)
    entry = torch.as_tensor(t_next, dtype=torch.int32,
                            device=alphas.device).expand(P, 1, B)
    return (torch.cat([(max_a + w_pen).expand(P, 1, B), new_a], dim=1),
            torch.cat([entry, new_e], dim=1), rec)


def viterbi_block_plain(carry: Carry, log_post: torch.Tensor, t0: int,
                        n_phonemes: int, n_states: int, w_penalty: float,
                        tr_curr: float, tr_next: float
                        ) -> Tuple[Carry, Hist]:
    """The scan as a Python loop of torch ops over frames, on any device."""
    alphas, ent = carry
    obs, hist, scalars = _setup(log_post, n_phonemes, n_states, w_penalty,
                                tr_curr, tr_next)
    for t in range(obs.shape[0]):
        alphas, ent, rec = _step(alphas, ent, obs[t], t0 + t + 1, *scalars)
        for h, r in zip(hist, rec):
            h[t] = r
    return (alphas, ent), hist


def viterbi_block_ragged_plain(carry: Carry, log_post: torch.Tensor,
                               t0: torch.Tensor, n_valid: torch.Tensor,
                               n_phonemes: int, n_states: int,
                               w_penalty: float, tr_curr: float,
                               tr_next: float) -> Tuple[Carry, Hist]:
    """The ragged scan as a Python loop of torch ops over frames, on any
    device: every frame steps every row, and rows past n_valid[b] keep
    their carry (their History rows hold whatever the step gave)."""
    alphas, ent = carry
    obs, hist, scalars = _setup(log_post, n_phonemes, n_states, w_penalty,
                                tr_curr, tr_next)
    t0 = t0.to(device=obs.device, dtype=torch.int32)
    n_valid = n_valid.to(device=obs.device, dtype=torch.int32)
    for t in range(obs.shape[0]):
        na, ne, rec = _step(alphas, ent, obs[t], t0 + t + 1, *scalars)
        live = (t < n_valid)[None, None, :]
        alphas = torch.where(live, na, alphas)
        ent = torch.where(live, ne, ent)
        for h, r in zip(hist, rec):
            h[t] = r
    return (alphas, ent), hist


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of a kernel-C library's entry points."""
    fn = lib.phn_viterbi
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p] * 2 + [ctypes.c_float] * 3
                       + [ctypes.c_void_p] * 6)
        fn.restype = ctypes.c_int
        lib.phn_viterbi_max_states.restype = ctypes.c_int
        lib.phn_viterbi_max_phonemes.restype = ctypes.c_int
        lib.phn_viterbi_max_row.restype = ctypes.c_int
        if hasattr(lib, "phn_viterbi_any_path"):
            lib.phn_viterbi_any_path.argtypes = [ctypes.c_int] * 2
            lib.phn_viterbi_any_path.restype = ctypes.c_int
    return lib


def _lib():
    return bind(_build.load("phnloop_viterbi"))


def launch(lib: ctypes.CDLL, carry: Carry, log_post: torch.Tensor, t0: int,
           t0_row, n_valid, n_phonemes: int, n_states: int,
           w_penalty: float, tr_curr: float, tr_next: float
           ) -> Tuple[Carry, Hist]:
    """Launch the kernel of ``lib`` (a bound kernel-C library) on CUDA
    tensors: kernel C with ``t0_row`` and ``n_valid`` None, else C'.
    Raises on anything it does not take; counts nothing."""
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
    for t, name in ((t0_row, "t0"), (n_valid, "n_valid")):
        if t is not None:
            _build.require(t, name, torch.int32, (B,), device)
    if P > lib.phn_viterbi_max_phonemes():
        raise ValueError(
            f"kernel takes at most {lib.phn_viterbi_max_phonemes()} "
            f"phonemes, not {P}: the History stores the winner as int8, as "
            "phnrec_tpu's does (which wraps past 127)")
    if not hasattr(lib, "phn_viterbi_any_path") and (
            S > lib.phn_viterbi_max_states() or
            D > lib.phn_viterbi_max_row()):
        raise ValueError(f"this kernel-C source takes at most "
                         f"{lib.phn_viterbi_max_states()} states and rows "
                         f"of {lib.phn_viterbi_max_row()} columns")
    out_a = torch.empty_like(alphas)
    out_e = torch.empty_like(ent)
    h_phn = torch.empty((T, B), dtype=torch.int8, device=device)
    h_ent = torch.empty((T, B), dtype=torch.int32, device=device)
    h_alpha = torch.empty((T, B), dtype=torch.float32, device=device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.phn_viterbi(
            alphas.data_ptr(), ent.data_ptr(), log_post.data_ptr(),
            B, T, P, S, D, int(t0), ptr(t0_row), ptr(n_valid), w_penalty,
            tr_curr, tr_next, out_a.data_ptr(), out_e.data_ptr(),
            h_phn.data_ptr(), h_ent.data_ptr(), h_alpha.data_ptr(), stream)
    _build.check(err, "phnloop_viterbi")
    return (out_a, out_e), (h_phn, h_ent, h_alpha)


def viterbi_block(carry: Carry, log_post: torch.Tensor, t0: int,
                  n_phonemes: int, n_states: int, w_penalty: float,
                  tr_curr: float, tr_next: float) -> Tuple[Carry, Hist]:
    """Kernel C, one block of frames: CPU tensors take the plain version;
    CUDA tensors launch the kernel (one launch for all T frames), and
    anything the kernel does not take raises."""
    args = (n_phonemes, n_states, w_penalty, tr_curr, tr_next)
    if log_post.device.type == "cpu":
        return viterbi_block_plain(carry, log_post, t0, *args)
    _build.cuda_device(log_post)       # raises before any build
    out = launch(_lib(), carry, log_post, t0, None, None, *args)
    global LAUNCHES
    LAUNCHES += 1
    return out


def viterbi_block_ragged(carry: Carry, log_post: torch.Tensor,
                         t0: torch.Tensor, n_valid: torch.Tensor,
                         n_phonemes: int, n_states: int, w_penalty: float,
                         tr_curr: float, tr_next: float
                         ) -> Tuple[Carry, Hist]:
    """Kernel C', one ragged block: t0 and n_valid are [B] int32 tensors
    on the log-posteriors' device.  CPU tensors take the plain version;
    CUDA tensors launch the kernel, and anything it does not take
    raises."""
    args = (n_phonemes, n_states, w_penalty, tr_curr, tr_next)
    if log_post.device.type == "cpu":
        return viterbi_block_ragged_plain(carry, log_post, t0, n_valid,
                                          *args)
    _build.cuda_device(log_post)
    out = launch(_lib(), carry, log_post, 0, t0, n_valid, *args)
    global RAGGED_LAUNCHES
    RAGGED_LAUNCHES += 1
    return out
