"""Fixed-shape re-estimation accumulators and utterance accumulation, on
torch tensors.

Counterpart of phnrec_tpu/train/accum.py: the equivalent of STK's
per-mixture/per-transition accumulators (allocated by
ModelSet::AllocateAccumulatorsForXformStats and filled by ReestState / the
FWBWRet machinery in STKLib/Viterbi.cc:1124-1240): one tuple of dense
tensors shaped by the ModelIndex, identical for every utterance.

Statistics (per model state j, mixture m — Models.h accumulator layout:
occupancy, first- and second-order sums):

  occ[j, m]     = sum_t gamma_jm(t)
  sum_x[j, m]   = sum_t gamma_jm(t) x_t
  sum_xx[j, m]  = sum_t gamma_jm(t) x_t^2
  trans[h, i, k] = expected transition counts routed through the graph's
                   COO edge table (cross-HMM arcs count toward both the
                   exit and entry cells).

The transition xi sums use the matmul identity
  xi_sum[i, j] = exp(log_A[i, j]) * sum_t a~_t[i] * b~_{t+1}[j]
with per-frame renormalized a~/b~, one [S, T] x [T, S] product an
utterance (torch.bmm over a bucket).  The scans are kernels K / K'
(train/fb.py); the einsums and products stay torch ops, and the
scatter-adds onto the model-state and transition tables are index_add_.

``accumulate_batch`` takes a bucket of B utterances at once (the batch
dimension written out where phnrec_tpu/train/loop.py vmaps);
``accumulate_utterance`` is a bucket of one.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from phnrec_tpu_torch.train.fb import (ObsTables, forward_backward, log_obs,
                                       obs_tables_numpy, viterbi_align)
from phnrec_tpu_torch.train.graph import ModelIndex, TrainGraph

# the TrainGraph fields a bucket carries to the device
GRAPH_FIELDS = ("log_A", "log_entry", "log_exit", "state_model", "e_src",
                "e_dst", "e_hmm", "e_row", "e_col", "en_state", "en_hmm",
                "en_row", "en_col", "ex_state", "ex_hmm", "ex_row", "ex_col")


class Accumulators(NamedTuple):
    occ: torch.Tensor                  # [NS, M] mixture occupancies
    sum_x: Optional[torch.Tensor]      # [NS, M, D] (None without GMMs)
    sum_xx: Optional[torch.Tensor]     # [NS, M, D]
    trans: torch.Tensor                # [H, N, N] transition counts
    n_frames: torch.Tensor             # [] weighted frame count
    total_log_like: torch.Tensor       # [] sum of utterance log-likes
    n_utts: torch.Tensor               # [] utterance count


def make_accumulators(index: ModelIndex, device="cuda") -> Accumulators:
    NS = index.n_model_states
    has_gmm = index.gmm_weights is not None
    M = index.gmm_weights.shape[1] if has_gmm else 1
    D = index.gmm_means.shape[2] if has_gmm else 0

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return Accumulators(
        occ=z(NS, M), sum_x=z(NS, M, D) if has_gmm else None,
        sum_xx=z(NS, M, D) if has_gmm else None,
        trans=z(index.n_hmms, index.max_states, index.max_states),
        n_frames=z(), total_log_like=z(), n_utts=z())


def merge_accumulators(a: Accumulators, b: Accumulators) -> Accumulators:
    return Accumulators(*(None if x is None else x + y for x, y in zip(a, b)))


def psum_accumulators(acc: Accumulators, mesh_or_group) -> Accumulators:
    """All-reduce (SUM) of every non-None field over the "data" group of a
    DeviceMesh, or over a ProcessGroup (parallel/mesh.py): each rank gets
    the summed Accumulators, as phnrec_tpu's psum over a mesh axis returns
    them.  ``acc`` itself is left as it was."""
    import torch.distributed as dist

    from phnrec_tpu_torch.parallel import mesh as meshlib
    from torch.distributed.device_mesh import DeviceMesh
    if isinstance(mesh_or_group, DeviceMesh):
        group = meshlib.data_axis(mesh_or_group).group
    elif isinstance(mesh_or_group, dist.ProcessGroup):
        group = mesh_or_group
    else:
        raise TypeError("psum_accumulators takes a DeviceMesh with a "
                        "'data' dimension or a ProcessGroup, not "
                        f"{type(mesh_or_group).__name__}")
    out = []
    for x in acc:
        if x is not None:
            x = x.clone()
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        out.append(x)
    return Accumulators(*out)


def stack_graphs(graphs, device) -> Dict[str, torch.Tensor]:
    """Graphs of one shape (pad_graph'ed) as [B, ...] tensors on
    ``device``, and their observation tables as an ObsTables of
    [B, S, ...] tensors under "tables"."""
    out = {k: torch.as_tensor(np.stack([getattr(g, k) for g in graphs]),
                              device=device) for k in GRAPH_FIELDS}
    parts = [obs_tables_numpy(g) for g in graphs]
    out["tables"] = ObsTables(*(
        None if col[0] is None else torch.as_tensor(np.stack(col),
                                                     device=device)
        for col in zip(*parts)))
    return out


def _gamma_stats(gb, x: torch.Tensor, log_gamma: torch.Tensor,
                 log_bm: Optional[torch.Tensor], log_b: torch.Tensor,
                 valid: torch.Tensor, weight: torch.Tensor, NS: int):
    """ML statistics of B utterances from state-level log occupancies
    [B, T, S], summed onto the model-state table."""
    tables: ObsTables = gb["tables"]
    sm = gb["state_model"].reshape(-1).long()               # [B*S]
    B, T, S = log_gamma.shape
    gamma = torch.where(valid[..., None], torch.exp(log_gamma), 0.0) * \
        weight[:, None, None]
    if log_bm is not None:
        # mixture responsibilities within each state: softmax of log_bm
        resp = torch.exp(log_bm - log_b[..., None])         # [B, T, S, M]
        resp = torch.where(torch.isfinite(resp), resp, 0.0)
        is_gmm = tables.is_gmm[:, None, :, None]
        gm = gamma[..., None] * torch.where(is_gmm, resp, 0.0)
        occ_g = gm.sum(1)                                    # [B, S, M]
        sx_g = torch.einsum("btsm,btd->bsmd", gm, x)
        sxx_g = torch.einsum("btsm,btd->bsmd", gm, x * x)
        # PDFObsVec states keep their state-level occupancy in column 0
        occ_g[:, :, 0] += torch.where(tables.is_gmm, 0.0, gamma.sum(1))
    else:
        occ_g = gamma.sum(1)[..., None]
        sx_g = sxx_g = None
    M = occ_g.shape[-1]
    dev = occ_g.device
    occ = torch.zeros((NS, M), device=dev).index_add_(
        0, sm, occ_g.reshape(B * S, M))
    sum_x = sum_xx = None
    if sx_g is not None:
        D = x.shape[-1]
        sum_x = torch.zeros((NS, M, D), device=dev).index_add_(
            0, sm, sx_g.reshape(B * S, M, D))
        sum_xx = torch.zeros((NS, M, D), device=dev).index_add_(
            0, sm, sxx_g.reshape(B * S, M, D))
    return occ, sum_x, sum_xx


def _route_trans(gb, xi: torch.Tensor, gamma0: torch.Tensor,
                 gammaN: torch.Tensor, H: int, N: int) -> torch.Tensor:
    """Scatter xi / entry / exit counts of B utterances onto the [H, N, N]
    accumulators (the COO edge tables, index_add_)."""
    tr = torch.zeros(H * N * N, device=xi.device)

    def cells(pre):
        return ((gb[pre + "_hmm"].long() * N + gb[pre + "_row"].long()) * N
                + gb[pre + "_col"].long()).reshape(-1)

    S = xi.shape[-1]
    e_val = xi.reshape(xi.shape[0], S * S).gather(
        1, (gb["e_src"].long() * S + gb["e_dst"].long()))
    tr.index_add_(0, cells("e"), e_val.reshape(-1))
    tr.index_add_(0, cells("en"),
                  gamma0.gather(1, gb["en_state"].long()).reshape(-1))
    tr.index_add_(0, cells("ex"),
                  gammaN.gather(1, gb["ex_state"].long()).reshape(-1))
    return tr.reshape(H, N, N)


def accumulate_batch(index: ModelIndex, gb, xs: torch.Tensor,
                     ns: torch.Tensor, ws: torch.Tensor,
                     mode: str = "baum_welch", mark=None
                     ) -> Tuple[Accumulators, torch.Tensor]:
    """One bucket of B utterances (``gb`` from stack_graphs; xs [B, T, D]
    features or log-posteriors, ns [B] frame counts, ws [B] weights) of
    Baum-Welch ('baum_welch', BaumWelchReest Viterbi.h:259) or
    hard-alignment ('viterbi', ViterbiReest Viterbi.h:256) statistics,
    summed over the bucket: one launch of kernel K or K'.  Returns the
    accumulators and the utterances' log-likelihoods [B].  ``mark``, when
    given, is called with a stage name after each stage ("log_obs",
    "scan", "stats")."""
    mark = mark or (lambda stage: None)
    if mode not in ("baum_welch", "viterbi"):
        raise ValueError(f"unknown accumulation mode {mode!r}")
    B, T = xs.shape[0], xs.shape[1]
    dev = xs.device
    n = ns.to(device=dev, dtype=torch.int64)
    ws = ws.to(device=dev, dtype=torch.float32)
    valid = torch.arange(T, device=dev)[None, :] < n[:, None]   # [B, T]
    log_b, log_bm = log_obs(gb["tables"], xs)
    log_b = torch.where(valid[..., None], log_b, 0.0)
    mark("log_obs")
    log_A = gb["log_A"]
    S = log_A.shape[-1]
    scan_args = (log_A, gb["log_entry"], gb["log_exit"], log_b, ns)

    if mode == "viterbi":
        al = viterbi_align(*scan_args)
        mark("scan")
        states = al.states.long()                                 # [B, T]
        one_hot = (states[..., None] == torch.arange(S, device=dev)
                   ).to(torch.float32)
        log_gamma = torch.where(one_hot > 0, 0.0, -torch.inf)
        ll = al.log_like
        # hard transition counts: consecutive (s_t, s_{t+1}) pairs
        nxt = torch.cat([states[:, 1:], states[:, -1:]], dim=1)
        pair = torch.arange(T, device=dev)[None, :] < (n - 1)[:, None]
        flat = ((torch.arange(B, device=dev)[:, None] * S
                 + states.clamp(min=0)) * S + nxt.clamp(min=0))
        xi = torch.zeros(B * S * S, device=dev).index_add_(
            0, flat.reshape(-1),
            torch.where(pair, ws[:, None], 0.0).reshape(-1)).reshape(B, S, S)
        gamma0 = one_hot[:, 0] * ws[:, None]
        last = (n - 1).clamp(min=0)
        gammaN = one_hot[torch.arange(B, device=dev), last] * ws[:, None]
    else:
        fb = forward_backward(*scan_args)
        mark("scan")
        ll = fb.log_like
        log_gamma = fb.log_alpha + fb.log_beta - ll[:, None, None]
        # xi via one product with per-frame renormalization (module doc)
        c = torch.logsumexp(fb.log_alpha, dim=2, keepdim=True)     # [B,T,1]
        a_n = torch.where(valid[..., None], torch.exp(fb.log_alpha - c), 0.0)
        a_shift = a_n[:, :-1]                                      # a~_t
        nxt_valid = (torch.arange(1, T, device=dev)[None, :]
                     < n[:, None])[..., None]
        b_shift = torch.exp(torch.where(
            nxt_valid,
            fb.log_beta[:, 1:] + log_b[:, 1:] + c[:, :-1]
            - ll[:, None, None], -torch.inf))
        xi = torch.exp(log_A) * torch.bmm(
            a_shift.transpose(1, 2), b_shift) * ws[:, None, None]
        gamma = torch.exp(log_gamma)
        gamma0 = torch.where(valid[:, :1], gamma[:, 0], 0.0) * ws[:, None]
        last = (n - 1).clamp(min=0)
        gammaN = gamma[torch.arange(B, device=dev), last] * ws[:, None]

    occ, sum_x, sum_xx = _gamma_stats(gb, xs, log_gamma, log_bm, log_b,
                                      valid, ws, index.n_model_states)
    trans = _route_trans(gb, xi, gamma0, gammaN, index.n_hmms,
                         index.max_states)
    acc = Accumulators(
        occ=occ, sum_x=sum_x, sum_xx=sum_xx, trans=trans,
        n_frames=(ws * n.to(torch.float32)).sum(),
        total_log_like=ll.sum(),
        n_utts=torch.tensor(float(B), device=dev))
    mark("stats")
    return acc, ll


def accumulate_utterance(graph: TrainGraph, acc: Accumulators, x, n_frames,
                         weight=1.0, mode: str = "baum_welch"
                         ) -> Accumulators:
    """One utterance of Baum-Welch or Viterbi statistics (see
    accumulate_batch) added to ``acc``, on acc's device.  ``x`` is [T, D]
    features (log-posteriors for <PDFObsVec> model sets); ``weight`` scales
    every statistic (the utterance weight of the Reest entry points, also
    how MCE weighting is applied — see update.mce_weight)."""
    dev = acc.occ.device
    gb = stack_graphs([graph], dev)
    x = torch.as_tensor(np.asarray(x, np.float32) if not isinstance(
        x, torch.Tensor) else x, device=dev).to(torch.float32)
    upd, _ = accumulate_batch(
        graph.index, gb, x[None],
        torch.tensor([int(n_frames)], dtype=torch.int32, device=dev),
        torch.tensor([float(weight)], dtype=torch.float32, device=dev), mode)
    return merge_accumulators(acc, upd)


def save_accumulators(acc: Accumulators, path: str) -> None:
    """Persist accumulators as phnrec_tpu does (one .npz, a field an
    array; STK dumps per-job accumulator files consumed by
    UpdateFromAccums(pOutputDir), Models.h:473); merge shards with
    merge_accumulators after loading."""
    np.savez(path, **{name: a.detach().cpu().numpy()
                      for name, a in zip(Accumulators._fields, acc)
                      if a is not None})


def load_accumulators(path: str, device="cuda") -> Accumulators:
    z = np.load(path)
    return Accumulators(*(torch.as_tensor(z[name], device=device)
                          if name in z else None
                          for name in Accumulators._fields))
