"""Parameter updates from accumulators: ML, extended-Baum-Welch (MMI), MCE.

Copy of phnrec_tpu/train/update.py (host numpy; the accumulators come
back from the device once an update).  The equivalent of ModelSet::UpdateFromAccums (STKLib/Models.h:473,
541,615; Models.cc) with update types AT_ML / AT_MMI (Viterbi.h:63-70) and
the MMI smoothing constants MMI_E / MMI_h / MMI_tauI (Models.h:336-338).
All updates are pure functions over the stacked accumulator arrays; the
result is written back into HmmDef/GMMState structures by apply_update so
the re-estimated set round-trips through the MMF writer.

ML (Baum-Welch M-step, the classic HTK equations):
  w_jm   = occ_jm / occ_j                      (floored, renormalized)
  mu_jm  = sum_x_jm / occ_jm
  var_jm = sum_xx_jm / occ_jm - mu_jm^2        (floored)
  a_ij   = trans_ij / sum_k trans_ik

MMI extended Baum-Welch (num/den accumulator pairs):
  D_jm    = max(E * occ_den_jm, h * D_min_jm)  where D_min_jm is the
            smallest D keeping every updated variance positive (found by
            doubling, the standard EBW safeguard),
  mu'_jm  = (sx_num - sx_den + D mu) / (occ_num - occ_den + D)
  var'_jm = (sxx_num - sxx_den + D (var + mu^2)) / (occ_num - occ_den + D)
            - mu'^2
  w'_jm  ~  w_jm * (occ_num_jm/occ_num_j - occ_den_jm/occ_den_j + C)
            (C chosen so all factors are positive; renormalized)

MCE: mce_weight computes the utterance weight from the true-path and
all-paths likelihoods exactly as Network::MCEReest (Viterbi.cc:2306-2314):
  F = TP - log(exp(P) - exp(TP));  w = slope*e^{-slope*F}/(1+e^{-slope*F})^2
The weight multiplies the utterance's (denominator) statistics at
accumulation time via accumulate_utterance(weight=...).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Optional, Set

import numpy as np

from phnrec_tpu_torch.io.mmf import GMMState, LOG_0, ModelSet
from phnrec_tpu_torch.train.accum import Accumulators
from phnrec_tpu_torch.train.graph import ModelIndex


@dataclass
class UpdatedParams:
    """Stacked re-estimated parameters (rows = ModelIndex state table)."""

    weights: Optional[np.ndarray]    # [NS, M]
    means: Optional[np.ndarray]      # [NS, M, D]
    variances: Optional[np.ndarray]  # [NS, M, D]
    log_transp: list                 # per-hmm [N, N] log matrices
    occ: np.ndarray                  # [NS, M] (for reporting/min-occ gates)


def _np(acc: Accumulators) -> Accumulators:
    """Accumulators (torch tensors on any device, or arrays) as numpy."""
    return Accumulators(*(None if a is None else (
        a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a))
        for a in acc))


def _update_trans(index: ModelIndex, trans: np.ndarray,
                  old: list) -> list:
    """Row-normalize transition counts; rows with no evidence keep the
    old parameters (HTK keeps unseen rows untouched)."""
    out = []
    for h in range(index.n_hmms):
        n = int(index.n_emitting[h]) + 2
        cnt = trans[h, :n, :n]
        row = cnt.sum(axis=1, keepdims=True)
        new = np.where(row > 0, cnt / np.maximum(row, 1e-30),
                       np.exp(np.minimum(old[h], 0)) * (old[h] > LOG_0))
        new[n - 1, :] = 0.0                       # exit row stays empty
        logm = np.full((n, n), LOG_0, np.float32)
        nz = new > 0
        logm[nz] = np.log(new[nz])
        out.append(logm)
    return out


def update_ml(index: ModelIndex, acc: Accumulators, old_transp: list,
              var_floor: float = 1e-4,
              weight_floor: float = 1e-5) -> UpdatedParams:
    """Maximum-likelihood M-step.  Low-occupancy gating happens at
    apply_update (its ``min_occ``), which keeps old parameters for
    mixtures whose occupancy is below the gate."""
    acc = _np(acc)
    weights = means = variances = None
    if acc.sum_x is not None and index.gmm_weights is not None:
        occ = acc.occ                                     # [NS, M]
        state_occ = occ.sum(axis=1, keepdims=True)
        safe = np.maximum(occ, 1e-30)
        means = acc.sum_x / safe[..., None]
        variances = acc.sum_xx / safe[..., None] - means ** 2
        variances = np.maximum(variances, var_floor)
        weights = np.where(state_occ > 0, occ / np.maximum(state_occ, 1e-30),
                           index.gmm_weights)
        weights = np.maximum(weights, np.where(
            index.gmm_weights > 0, weight_floor, 0.0))
        norm = weights.sum(axis=1, keepdims=True)
        weights = np.where(norm > 0, weights / np.maximum(norm, 1e-30), 0.0)
    return UpdatedParams(
        weights=weights, means=means, variances=variances,
        log_transp=_update_trans(index, acc.trans, old_transp),
        occ=acc.occ)


def update_mmi(index: ModelIndex, num: Accumulators, den: Accumulators,
               old_transp: list, E: float = 2.0, h: float = 2.0,
               var_floor: float = 1e-4, min_occ: float = 1e-2,
               weight_c: float = 2.0) -> UpdatedParams:
    """Extended-Baum-Welch discriminative update from numerator (forced
    alignment) and denominator (recognition network) accumulators —
    the AT_MMI path with constants E/h (Models.h:336-338)."""
    if index.gmm_weights is None:
        raise ValueError("MMI update requires GMM output distributions")
    num, den = _np(num), _np(den)
    mu0 = index.gmm_means.astype(np.float64)
    var0 = index.gmm_vars.astype(np.float64)
    w0 = index.gmm_weights.astype(np.float64)

    d_occ = num.occ - den.occ                            # [NS, M]
    d_sx = num.sum_x - den.sum_x
    d_sxx = num.sum_xx - den.sum_xx

    # smallest D keeping variances positive, by doubling from E*occ_den
    D = np.maximum(E * den.occ, 1e-2)
    for _ in range(32):
        denom = (d_occ + D)[..., None]
        mu = (d_sx + D[..., None] * mu0) / np.maximum(denom, 1e-30)
        var = (d_sxx + D[..., None] * (var0 + mu0 ** 2)) / \
            np.maximum(denom, 1e-30) - mu ** 2
        bad = (denom[..., 0] <= 0) | (var.min(axis=-1) <= var_floor)
        if not bad.any():
            break
        D = np.where(bad, D * h, D)
    variances = np.maximum(var, var_floor).astype(np.float32)
    means = mu.astype(np.float32)

    occ_num_j = np.maximum(num.occ.sum(axis=1, keepdims=True), 1e-30)
    occ_den_j = np.maximum(den.occ.sum(axis=1, keepdims=True), 1e-30)
    w = w0 * (num.occ / occ_num_j - den.occ / occ_den_j + weight_c)
    w = np.maximum(w, 0.0) * (w0 > 0)
    norm = np.maximum(w.sum(axis=1, keepdims=True), 1e-30)
    weights = (w / norm).astype(np.float32)

    return UpdatedParams(
        weights=weights, means=means, variances=variances,
        log_transp=_update_trans(index, num.trans, old_transp),
        occ=num.occ)


def mce_weight(true_path_like: float, all_paths_like: float,
               sig_slope: float) -> float:
    """Utterance weight for MCE re-estimation (Viterbi.cc:2306-2314):
    F = TP - LogSub(P, TP); weight = slope*e^{-s F} / (1 + e^{-s F})^2."""
    tp, p = float(true_path_like), float(all_paths_like)
    if p <= tp:                     # no competing mass: zero gradient
        return 0.0
    f = tp - (p + np.log1p(-np.exp(min(tp - p, -1e-10))))
    e = np.exp(-sig_slope * f)
    return float(sig_slope * e / (1.0 + e) ** 2)


def apply_update(models: ModelSet, index: ModelIndex, upd: UpdatedParams,
                 min_occ: float = 1e-2,
                 update: Set[str] = frozenset("mvwt")) -> ModelSet:
    """Write re-estimated parameters back into a (deep-copied) ModelSet.
    ``update`` selects parameter classes like HTK's -u flag: m(eans),
    v(ariances), w(eights), t(ransitions).  Mixtures whose occupancy is
    below ``min_occ`` keep their old parameters."""
    out = copy.deepcopy(models)
    row = 0
    for hid, name in enumerate(index.names):
        hmm = out.hmms[name]
        if "t" in update:
            hmm.log_transp = upd.log_transp[hid]
        for p in range(int(index.n_emitting[hid])):
            g: Optional[GMMState] = hmm.gmm_states[p]
            if g is not None and upd.means is not None:
                m = g.weights.shape[0]
                keep = upd.occ[row, :m] < min_occ
                if "m" in update:
                    g.means = np.where(keep[:, None], g.means,
                                       upd.means[row, :m]).astype(np.float32)
                if "v" in update:
                    g.variances = np.where(
                        keep[:, None], g.variances,
                        upd.variances[row, :m]).astype(np.float32)
                if "w" in update:
                    neww = np.where(keep, g.weights, upd.weights[row, :m])
                    s = neww.sum()
                    g.weights = (neww / max(s, 1e-30)).astype(np.float32)
                g.gconsts = (g.means.shape[1] * np.log(2 * np.pi)
                             + np.log(g.variances).sum(axis=1)
                             ).astype(np.float32)
            row += 1
    return out
