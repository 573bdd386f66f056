"""Batched forward-backward / Viterbi alignment over dense training graphs,
on torch tensors.

Counterpart of phnrec_tpu/train/fb.py: the equivalent of
Network::ForwardBackward (STKLib/Viterbi.cc:2115+) with PassTokenSum
(Viterbi.cc:603-646) and the Viterbi alignment pass with PassTokenMax
(Viterbi.cc:543-567).  Observation log-probs are either posterior lookups
(<PDFObsVec>/<ObsCoef> states, Viterbi.cc:760-768) or DiagC GMM densities
(DiagCGaussianMixtureDensity, Viterbi.cc:719-755), both precomputed for all
frames as two quadratic-form GEMMs (torch.matmul).  The frame scans are
kernels K (forward-backward) and K' (alignment) of ops/trainfb.py on the
card, their plain versions on CPU tensors.

Every function takes one utterance ([T, S] log_b, graphs [S, S]) or a
bucket batch ([B, T, S], graphs [B, S, S]) and ``n_frames``; scan steps at
t >= n_frames leave the carry untouched and emit NEG_INF rows.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from phnrec_tpu_torch.ops import trainfb
from phnrec_tpu_torch.train.graph import ModelIndex, TrainGraph

NEG_INF = trainfb.NEG_INF


class ObsTables(NamedTuple):
    """Per-graph-state observation parameters on the device ([S, ...], or
    [B, S, ...] for a bucket)."""

    obs_coef: torch.Tensor            # [S] posterior column (-1 = GMM)
    is_gmm: torch.Tensor              # [S] bool
    # stacked quadratic-form coefficients for log N(x; mu, var):
    #   logN_m(x) = -0.5*(gconst + x^2 . iv - 2 x . miv + mu^2 . iv)
    log_w: Optional[torch.Tensor]     # [S, M] (NEG_INF pad)
    iv: Optional[torch.Tensor]        # [S, M, D] 1/var
    miv: Optional[torch.Tensor]       # [S, M, D] mu/var
    c: Optional[torch.Tensor]         # [S, M] gconst + sum mu^2/var


def obs_tables_numpy(graph: TrainGraph) -> tuple:
    """ObsTables' fields as numpy arrays (phnrec_tpu's make_obs_tables)."""
    idx: ModelIndex = graph.index
    sm = graph.state_model
    obs_coef = idx.state_obs_coef[sm]
    if idx.gmm_weights is None:
        return obs_coef, obs_coef < 0, None, None, None, None
    w = idx.gmm_weights[sm]                       # [S, M]
    mu = idx.gmm_means[sm]
    var = idx.gmm_vars[sm]
    gc = idx.gmm_gconsts[sm]
    nm = idx.gmm_nmix[sm]
    M = w.shape[1]
    valid = np.arange(M)[None, :] < nm[:, None]
    log_w = np.where(valid & (w > 0), np.log(np.maximum(w, 1e-37)),
                     NEG_INF).astype(np.float32)
    iv = (1.0 / var).astype(np.float32)
    miv = (mu / var).astype(np.float32)
    c = np.where(valid, gc + (mu * mu / var).sum(-1), 0.0).astype(np.float32)
    return obs_coef, obs_coef < 0, log_w, iv, miv, c


def make_obs_tables(graph: TrainGraph, device="cuda") -> ObsTables:
    return ObsTables(*(None if a is None else torch.as_tensor(a, device=device)
                       for a in obs_tables_numpy(graph)))


def log_obs(tables: ObsTables, x: torch.Tensor
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """[T, D] (or [B, T, D]) features, or log-posteriors for <PDFObsVec>
    states -> (log_b [.., T, S], per-mixture log_bm [.., T, S, M] or
    None)."""
    idx = tables.obs_coef.clamp(min=0).long()
    if x.dim() == 2:
        lookup = x[:, idx]                                   # [T, S]
    else:
        lookup = torch.gather(x, 2, idx[:, None, :].expand(
            -1, x.shape[1], -1))                             # [B, T, S]
    if tables.log_w is None:
        return lookup, None
    S, M, D = tables.iv.shape[-3:]
    lead = tables.iv.shape[:-3]
    iv2 = tables.iv.reshape(*lead, S * M, D).transpose(-1, -2)
    miv2 = tables.miv.reshape(*lead, S * M, D).transpose(-1, -2)
    # the quadratic form via two GEMMs: x^2 @ iv^T and x @ miv^T
    q = (torch.matmul(x * x, iv2) - 2.0 * torch.matmul(x, miv2)).reshape(
        *x.shape[:-1], S, M) + tables.c.unsqueeze(-3)
    log_bm = tables.log_w.unsqueeze(-3) - 0.5 * q            # [.., T, S, M]
    gmm_b = torch.logsumexp(log_bm, dim=-1)
    log_b = torch.where(tables.is_gmm.unsqueeze(-2), gmm_b, lookup)
    return log_b, log_bm


class FBResult(NamedTuple):
    log_alpha: torch.Tensor   # [.., T, S] (NEG_INF beyond n_frames)
    log_beta: torch.Tensor    # [.., T, S] (log_b excluded at t itself)
    log_like: torch.Tensor    # [..] total log-likelihood


class AlignResult(NamedTuple):
    states: torch.Tensor      # [.., T] best graph state per frame (-1 pad)
    log_like: torch.Tensor    # [..] Viterbi path score


def _batch(log_A, log_entry, log_exit, log_b, n_frames):
    """The scan arguments as float32 / int32 tensors with a batch
    dimension, on log_b's device (a tensor's own, else the card); and
    whether the batch dimension was added."""
    dev = (log_b.device if isinstance(log_b, torch.Tensor)
           else torch.device("cuda"))
    single = np.ndim(log_b) == 2

    def f32(a):
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(np.asarray(a, np.float32))
        a = a.to(device=dev, dtype=torch.float32)
        return (a[None] if single else a).contiguous()

    n = torch.as_tensor(n_frames, device=dev).to(torch.int32).reshape(-1)
    return (f32(log_A), f32(log_entry), f32(log_exit), f32(log_b),
            n.contiguous(), single)


def forward_backward(log_A, log_entry, log_exit, log_b,
                     n_frames) -> FBResult:
    """Dense-graph forward-backward: one launch of kernel K on the card."""
    *args, single = _batch(log_A, log_entry, log_exit, log_b, n_frames)
    out = trainfb.graph_fb(*args)
    return FBResult(*(o[0] for o in out) if single else out)


def viterbi_align(log_A, log_entry, log_exit, log_b,
                  n_frames) -> AlignResult:
    """Max-plus alignment (PassTokenMax, Viterbi.cc:543-567) and its
    traceback: one launch of kernel K' on the card."""
    *args, single = _batch(log_A, log_entry, log_exit, log_b, n_frames)
    out = trainfb.graph_align(*args)
    return AlignResult(*(o[0] for o in out) if single else out)
