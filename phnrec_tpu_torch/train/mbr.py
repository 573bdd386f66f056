"""MPE / state-level minimum-Bayes-risk discriminative statistics, on torch
tensors.

Counterpart of phnrec_tpu/train/mbr.py.  The AT_MPE accumulation type of
STK (Viterbi.h:67) weights denominator occupancies by how much each path's
local accuracy deviates from the average; this is the frame-state-level
variant (sMBR) over a denominator graph (typically the phoneme loop):

    kappa_t(s) = gamma_t(s) * (A(s, t) - Abar(t))
    A(s, t)    = 1 if state s belongs to the reference phone at frame t
    Abar(t)    = sum_s gamma_t(s) A(s, t)     (expected accuracy)

Positive kappa mass accumulates into the numerator-side statistics and
negative mass (absolute value) into the denominator side; the pair feeds
the extended-Baum-Welch update (train.update.update_mmi).  Transition
statistics are not MBR-weighted (HTK/STK practice).  The forward-backward
is kernel K on the card.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from phnrec_tpu_torch.train.accum import (Accumulators, _gamma_stats,
                                          merge_accumulators, stack_graphs)
from phnrec_tpu_torch.train.fb import forward_backward, log_obs
from phnrec_tpu_torch.train.graph import TrainGraph


def accumulate_utterance_mbr(graph: TrainGraph, acc_num: Accumulators,
                             acc_den: Accumulators, x, ref_hmm_ids,
                             n_frames, weight: float = 1.0
                             ) -> Tuple[Accumulators, Accumulators]:
    """One utterance of sMBR statistics over the denominator ``graph``, on
    the accumulators' device.

    ``ref_hmm_ids``: [T] hmm id (row into graph.index.names) of the
    reference phone at each frame — from a forced alignment of the
    numerator transcription (train.fb.viterbi_align + reference_hmm_ids).
    Returns the updated (numerator, denominator) accumulators."""
    dev = acc_num.occ.device
    gb = stack_graphs([graph], dev)
    x = torch.as_tensor(np.asarray(x, np.float32) if not isinstance(
        x, torch.Tensor) else x, device=dev).to(torch.float32)[None]
    T = x.shape[1]
    n = int(n_frames)
    valid = torch.arange(T, device=dev)[None, :] < n           # [1, T]
    log_b, log_bm = log_obs(gb["tables"], x)
    log_b = torch.where(valid[..., None], log_b, 0.0)
    ns = torch.tensor([n], dtype=torch.int32, device=dev)
    fb = forward_backward(gb["log_A"], gb["log_entry"], gb["log_exit"],
                          log_b, ns)
    log_gamma = fb.log_alpha + fb.log_beta - fb.log_like[:, None, None]
    gamma = torch.where(valid[..., None], torch.exp(log_gamma), 0.0)

    state_hmm = torch.as_tensor(
        graph.index.state_hmm[graph.state_model], device=dev)    # [S]
    ref = torch.as_tensor(np.asarray(ref_hmm_ids), device=dev)
    A = (state_hmm[None, :] == ref[:, None]).to(torch.float32)[None]
    abar = torch.sum(gamma * A, dim=2, keepdim=True)
    kappa = gamma * (A - abar) * np.float32(weight)            # signed
    pos = torch.clamp(kappa, min=0.0)
    neg = torch.clamp(-kappa, min=0.0)
    one = torch.ones(1, device=dev)

    def stats(g):
        lg = torch.where(g > 0, torch.log(torch.clamp(g, min=1e-37)),
                         -torch.inf)
        return _gamma_stats(gb, x, lg, log_bm, log_b, valid, one,
                            graph.index.n_model_states)

    occ_p, sx_p, sxx_p = stats(pos)
    occ_n, sx_n, sxx_n = stats(neg)
    zero_tr = torch.zeros_like(acc_num.trans)
    zero = torch.zeros((), device=dev)
    upd_num = Accumulators(
        occ=occ_p, sum_x=sx_p, sum_xx=sxx_p, trans=zero_tr,
        n_frames=torch.tensor(float(np.float32(weight) * np.float32(n)),
                              device=dev),
        total_log_like=fb.log_like[0], n_utts=torch.ones((), device=dev))
    upd_den = Accumulators(occ=occ_n, sum_x=sx_n, sum_xx=sxx_n,
                           trans=zero_tr, n_frames=zero,
                           total_log_like=zero, n_utts=zero)
    return (merge_accumulators(acc_num, upd_num),
            merge_accumulators(acc_den, upd_den))


def reference_hmm_ids(graph: TrainGraph, states) -> np.ndarray:
    """[T] aligned graph states (train.fb.viterbi_align on the NUMERATOR
    graph) -> [T] hmm ids for accumulate_utterance_mbr (padded -1 -> -1)."""
    st = (states.cpu().numpy() if isinstance(states, torch.Tensor)
          else np.asarray(states))
    hmm_of_state = graph.index.state_hmm[graph.state_model]
    out = np.where(st >= 0, hmm_of_state[np.maximum(st, 0)], -1)
    return out.astype(np.int32)
