"""Kernel J: the phoneme-loop forward-backward (csrc/trainfb.cu), with its
plain PyTorch version and its launch count.

Counterpart of phnrec_tpu/decoder/forward_backward.py::forward_backward
(scans at :78 and :104), over a batch: log_post [B, T, D >= P*S] (phoneme p
state s reads column p*S + s) -> (log_alpha [B, T, P, S], log_beta
[B, T, P, S], log_like [B]).  Forwards each frame takes logaddexp of the
self-loop, the advance and (state 0) the loop node's entry, the entry being
the lse over the P exit states + tr_next, + w_penalty (already w_penalty at
t = 0, the reference quirk); backwards each frame the re-entry lse over the
P first states.  Both versions sum their exps in their own order, so they
agree with each other and with JAX to a tolerance, not bit for bit.

On the card the kernel has two instances, picked by the loop's size
(``plan_instance``): up to GROUP_MAX_STATES states a block an utterance
that runs the two scans side by side, each on a group of at most
GROUP_WARPS warps with the states in registers and one barrier a frame;
past it a block an utterance with a thread a state and the frame's
values in shared memory.  Each has its own launch count.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from phnrec_tpu_torch.ops import _build
from phnrec_tpu_torch.ops.trainfb import _f32, _lib, scratch

LAUNCHES = 0         # the block instance
GROUP_LAUNCHES = 0   # the group instance

# kernel J's instances (csrc/trainfb.cu): up to GROUP_MAX_STATES states a
# group of warps a scan, GROUP_EPLS states a thread (the smallest that
# GROUP_WARPS warps hold them in), as few warps as hold them; a thread a
# state past it
INSTANCES = ("group", "block")
GROUP_MAX_STATES = 1024
GROUP_EPLS = (1, 2, 4, 8)
GROUP_WARPS = 4

NEG = float(-np.finfo(np.float32).max)   # the phoneme loop's NEG_INF

Out = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def phnloop_fb_plain(log_post: torch.Tensor, n_phonemes: int, n_states: int,
                     w_penalty: float, tr_curr: float, tr_next: float) -> Out:
    """The forward and backward scans as Python loops of torch ops over
    frames, on any device."""
    P, S = n_phonemes, n_states
    B, T = log_post.shape[0], log_post.shape[1]
    obs = log_post[:, :, : P * S].reshape(B, T, P, S)
    tr_c, tr_n, w_pen = _f32(tr_curr), _f32(tr_next), _f32(w_penalty)
    kw = dict(dtype=torch.float32, device=log_post.device)
    neg1 = torch.full((B, P, 1), NEG, **kw)
    neg_rest = torch.full((B, P, S - 1), NEG, **kw)
    alphas = torch.empty((B, T, P, S), **kw)
    betas = torch.empty((B, T, P, S), **kw)

    alpha = torch.full((B, P, S), NEG, **kw)
    entry = torch.full((B,), w_pen, **kw)
    for t in range(T):
        stay = alpha + tr_c
        adv = torch.cat([neg1, alpha[:, :, :-1] + tr_n], dim=2)
        inc = torch.cat([entry[:, None, None].expand(B, P, 1), neg_rest],
                        dim=2)
        alpha = torch.logaddexp(torch.logaddexp(stay, adv), inc) + obs[:, t]
        entry = torch.logsumexp(alpha[:, :, -1] + tr_n, dim=1) + w_pen
        alphas[:, t] = alpha
    like = torch.logsumexp(alpha[:, :, -1], dim=1)

    beta = torch.cat([neg_rest, torch.zeros((B, P, 1), **kw)], dim=2)
    for t in range(T - 1, -1, -1):
        betas[:, t] = beta
        b_obs = beta + obs[:, t]
        stay = b_obs + tr_c
        adv = torch.cat([b_obs[:, :, 1:] + tr_n, neg1], dim=2)
        reentry = torch.logsumexp(b_obs[:, :, 0], dim=1) + w_pen
        ext = torch.cat([neg_rest, (tr_n + reentry)[:, None, None]
                         .expand(B, P, 1)], dim=2)
        beta = torch.logaddexp(torch.logaddexp(stay, adv), ext)
    return alphas, betas, like


def group_shape(n: int) -> Tuple[int, int]:
    """The group instance's (states a thread, warps a scan) for a loop of
    n <= GROUP_MAX_STATES states."""
    epl = next(c for c in GROUP_EPLS if GROUP_WARPS * 32 * c >= n)
    return epl, -(-n // (32 * epl))


def plan_instance(n_phonemes: int, n_states: int,
                  lib: Optional[ctypes.CDLL] = None) -> str:
    """The instance that takes a loop, by its size alone: "group" up to
    GROUP_MAX_STATES states, else "block" (always "block" for a ``lib``
    built from a source without the group instance)."""
    if lib is not None and not hasattr(lib, "phn_loop_fb_group"):
        return "block"
    return ("group" if n_phonemes * n_states <= GROUP_MAX_STATES
            else "block")


def launch(lib: ctypes.CDLL, log_post: torch.Tensor, n_phonemes: int,
           n_states: int, w_penalty: float, tr_curr: float,
           tr_next: float, instance: Optional[str] = None) -> Out:
    """Launch kernel J of ``lib`` on CUDA tensors, the given instance
    (None: ``plan_instance``); raises on anything it does not take;
    counts nothing."""
    device = _build.cuda_device(log_post)
    P, S = n_phonemes, n_states
    if log_post.dim() != 3:
        raise ValueError("log_post must be [B, T, D]")
    B, T, D = log_post.shape
    if P < 1 or S < 1 or D < P * S:
        raise ValueError(f"log_post has {D} columns, needs {P * S}")
    if B * max(T, 1) * max(D, P * S) >= 2 ** 62:
        raise ValueError("log_post too large")
    _build.require(log_post, "log_post", torch.float32, (B, T, D), device)
    alpha = torch.empty((B, T, P, S), dtype=torch.float32, device=device)
    beta = torch.empty_like(alpha)
    like = torch.empty(B, dtype=torch.float32, device=device)
    instance = instance or plan_instance(P, S, lib)
    if instance not in INSTANCES:
        raise ValueError(f"no instance {instance!r}")
    group = instance == "group"
    if group and plan_instance(P, S) != "group":
        raise ValueError(f"the group instance takes up to "
                         f"{GROUP_MAX_STATES} states (got {P * S})")
    scr = None if group else scratch(lib, B, P * S, device)
    fn = lib.phn_loop_fb_group if group else lib.phn_loop_fb
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            log_post.data_ptr(), B, T, D, P, S, _f32(w_penalty),
            _f32(tr_curr), _f32(tr_next), alpha.data_ptr(), beta.data_ptr(),
            like.data_ptr(), None if scr is None else scr.data_ptr(), stream)
    _build.check(err, "phn_loop_fb_group" if group else "phn_loop_fb")
    return alpha, beta, like


def phnloop_fb(log_post: torch.Tensor, n_phonemes: int, n_states: int,
               w_penalty: float, tr_curr: float, tr_next: float) -> Out:
    """Kernel J over a batch [B, T, D]: CPU tensors take the plain version;
    CUDA tensors launch the instance the loop's size picks (one launch,
    both scans), and anything the kernel does not take raises."""
    args = (n_phonemes, n_states, w_penalty, tr_curr, tr_next)
    if log_post.device.type == "cpu":
        return phnloop_fb_plain(log_post, *args)
    _build.cuda_device(log_post)       # raises before any build
    inst = plan_instance(n_phonemes, n_states)
    out = launch(_lib(), log_post, *args, instance=inst)
    global LAUNCHES, GROUP_LAUNCHES
    if inst == "group":
        GROUP_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out
