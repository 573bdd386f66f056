"""Embedded-training graph: transcription -> dense linear composite HMM.

Copy of phnrec_tpu/train/graph.py (numpy-only host code, kept in step with
it).

STK builds a left-to-right network from each utterance's transcription and
runs token passing / forward-backward over it (the AlignmentType machinery
around Network::ForwardBackward, STKLib/Viterbi.cc:2115+).  Here the same
composite collapses into dense tensors for batched products:

  * ``log_A [S, S]``      transition log-probs between the S concatenated
                          emitting states (within-HMM rows come straight
                          from each <TRANSP>, cross-HMM edges are
                          exit-prob + next entry-prob),
  * ``log_entry [S]``     composite entry distribution (first HMM's
                          entry row),
  * ``log_exit [S]``      composite termination (last HMM's exit column),
  * observation lookup per state: PDFObsVec posterior column
    (Models_IO.cc:795-835) or stacked DiagC GMM parameters.

Tee models (direct entry->exit transitions) are rejected: no phnrec model
package has them (<TRANSP> rows generated by netgen.cpp:22-88 are strictly
left-to-right).

Accumulator routing: every graph state carries the global id of the model
state it instantiates, and every finite edge of ``log_A`` (plus entry/exit)
carries the (hmm, row, col) cells of the source <TRANSP> accumulators it
must be counted toward — a cross-HMM edge counts toward BOTH the exiting
HMM's exit cell and the entered HMM's entry cell, exactly how STK splits a
network arc's occupancy between the two transition matrices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from phnrec_tpu_torch.io.mmf import HmmDef, LOG_0, ModelSet


@dataclass(frozen=True)
class ModelIndex:
    """Fixed-shape stacked views of a ModelSet, shared by every utterance
    graph so accumulators have one static shape per model set."""

    names: Tuple[str, ...]                  # hmm id -> name
    n_emitting: np.ndarray                  # [H] emitting states per hmm
    max_states: int                         # max n_states (incl entry/exit)
    # model-state table: one row per (hmm, emitting state)
    state_hmm: np.ndarray                   # [NS] hmm id
    state_pos: np.ndarray                   # [NS] emitting index within hmm
    state_obs_coef: np.ndarray              # [NS] posterior column or -1
    # stacked GMM parameters (rows align with the state table; M padded)
    gmm_weights: Optional[np.ndarray]       # [NS, M]  (0 pad)
    gmm_means: Optional[np.ndarray]         # [NS, M, D]
    gmm_vars: Optional[np.ndarray]          # [NS, M, D] (1 pad)
    gmm_gconsts: Optional[np.ndarray]       # [NS, M]  (+inf pad)
    gmm_nmix: Optional[np.ndarray]          # [NS]

    @property
    def n_hmms(self) -> int:
        return len(self.names)

    @property
    def n_model_states(self) -> int:
        return self.state_hmm.shape[0]

    def state_id(self, hmm_id: int, pos: int) -> int:
        return int(self._first[hmm_id]) + pos

    def __post_init__(self):
        first = np.zeros(len(self.names), np.int32)
        np.cumsum(self.n_emitting[:-1], out=first[1:])
        object.__setattr__(self, "_first", first)


def build_model_index(models: ModelSet,
                      names: Optional[Sequence[str]] = None) -> ModelIndex:
    """Stack a ModelSet's HMMs into fixed-shape arrays (GMM dims padded to
    the set-wide max mixture count)."""
    names = tuple(names if names is not None else sorted(models.hmms))
    hmms: List[HmmDef] = [models.hmms[n] for n in names]
    n_emit = np.asarray([h.n_states - 2 for h in hmms], np.int32)
    state_hmm, state_pos, state_obs = [], [], []
    gmms = []
    for hid, h in enumerate(hmms):
        for p in range(h.n_states - 2):
            state_hmm.append(hid)
            state_pos.append(p)
            oc = h.obs_coefs[p]
            state_obs.append(-1 if oc is None else oc)
            gmms.append(h.gmm_states[p])

    any_gmm = any(g is not None for g in gmms)
    gw = gm = gv = gc = gn = None
    if any_gmm:
        M = max(g.weights.shape[0] for g in gmms if g is not None)
        D = next(g.means.shape[1] for g in gmms if g is not None)
        NS = len(gmms)
        gw = np.zeros((NS, M), np.float32)
        gm = np.zeros((NS, M, D), np.float32)
        gv = np.ones((NS, M, D), np.float32)
        gc = np.full((NS, M), np.inf, np.float32)
        gn = np.zeros(NS, np.int32)
        for i, g in enumerate(gmms):
            if g is None:
                continue
            m = g.weights.shape[0]
            gw[i, :m] = g.weights
            gm[i, :m] = g.means
            gv[i, :m] = g.variances
            gc[i, :m] = g.gconsts
            gn[i] = m

    return ModelIndex(
        names=names, n_emitting=n_emit,
        max_states=max(h.n_states for h in hmms),
        state_hmm=np.asarray(state_hmm, np.int32),
        state_pos=np.asarray(state_pos, np.int32),
        state_obs_coef=np.asarray(state_obs, np.int32),
        gmm_weights=gw, gmm_means=gm, gmm_vars=gv, gmm_gconsts=gc,
        gmm_nmix=gn)


@dataclass(frozen=True)
class TrainGraph:
    """Dense linear composite HMM over one transcription."""

    index: ModelIndex
    log_A: np.ndarray          # [S, S]
    log_entry: np.ndarray      # [S]
    log_exit: np.ndarray       # [S]
    state_model: np.ndarray    # [S] global model-state id (ModelIndex row)
    # transition-accumulator routing (COO over every counted edge):
    #   edge e: xi weight of (src[e] -> dst[e]) adds to
    #   trans cell (t_hmm[e], t_row[e], t_col[e]).  Entry/exit edges use
    #   src/dst = -1 markers and are accumulated from gamma_0 / gamma_T.
    e_src: np.ndarray          # [E] graph state (xi row)
    e_dst: np.ndarray          # [E] graph state (xi col)
    e_hmm: np.ndarray          # [E] target transp accumulator
    e_row: np.ndarray          # [E]
    e_col: np.ndarray          # [E]
    en_state: np.ndarray       # [En] graph states counted for entry rows
    en_hmm: np.ndarray
    en_row: np.ndarray
    en_col: np.ndarray
    ex_state: np.ndarray       # [Ex] graph states counted for exit cells
    ex_hmm: np.ndarray
    ex_row: np.ndarray
    ex_col: np.ndarray

    @property
    def n_states(self) -> int:
        return self.log_A.shape[0]


def compile_transcription(models: ModelSet, transcription: Sequence[str],
                          index: Optional[ModelIndex] = None) -> TrainGraph:
    """[hmm names] -> TrainGraph (the linear embedded-training network)."""
    if index is None:
        index = build_model_index(models)
    name_to_id: Dict[str, int] = {n: i for i, n in enumerate(index.names)}
    insts = []
    for name in transcription:
        if name not in name_to_id:
            raise ValueError(f"transcription uses unknown HMM {name!r}")
        insts.append(name_to_id[name])

    hmms = [models.hmms[index.names[h]] for h in insts]
    for h in hmms:
        N = h.n_states
        if h.log_transp[0, N - 1] > LOG_0:
            raise ValueError(f"tee model {h.name!r} unsupported in training"
                             " graphs (no phnrec model has one)")

    sizes = [h.n_states - 2 for h in hmms]
    offs = np.zeros(len(hmms) + 1, np.int32)
    np.cumsum(sizes, out=offs[1:])
    S = int(offs[-1])

    log_A = np.full((S, S), LOG_0, np.float32)
    log_entry = np.full(S, LOG_0, np.float32)
    log_exit = np.full(S, LOG_0, np.float32)
    state_model = np.zeros(S, np.int32)

    e_src, e_dst, e_hmm, e_row, e_col = [], [], [], [], []
    en_state, en_hmm, en_row, en_col = [], [], [], []
    ex_state, ex_hmm, ex_row, ex_col = [], [], [], []

    for k, (hid, h) in enumerate(zip(insts, hmms)):
        n = sizes[k]
        N = h.n_states
        o = int(offs[k])
        tr = h.log_transp
        for i in range(n):
            state_model[o + i] = index.state_id(hid, i)
            for j in range(n):
                if tr[i + 1, j + 1] > LOG_0:
                    log_A[o + i, o + j] = tr[i + 1, j + 1]
                    e_src.append(o + i); e_dst.append(o + j)
                    e_hmm.append(hid); e_row.append(i + 1); e_col.append(j + 1)
        if k == 0:
            for j in range(n):
                if tr[0, j + 1] > LOG_0:
                    log_entry[o + j] = tr[0, j + 1]
                    en_state.append(o + j)
                    en_hmm.append(hid); en_row.append(0); en_col.append(j + 1)
        if k == len(hmms) - 1:
            for i in range(n):
                if tr[i + 1, N - 1] > LOG_0:
                    log_exit[o + i] = tr[i + 1, N - 1]
                    ex_state.append(o + i)
                    ex_hmm.append(hid); ex_row.append(i + 1); ex_col.append(N - 1)
        else:
            hid2, h2 = insts[k + 1], hmms[k + 1]
            n2, o2 = sizes[k + 1], int(offs[k + 1])
            tr2 = h2.log_transp
            for i in range(n):
                if tr[i + 1, N - 1] <= LOG_0:
                    continue
                for j in range(n2):
                    if tr2[0, j + 1] <= LOG_0:
                        continue
                    log_A[o + i, o2 + j] = tr[i + 1, N - 1] + tr2[0, j + 1]
                    # the cross edge counts toward BOTH transp accumulators
                    e_src.append(o + i); e_dst.append(o2 + j)
                    e_hmm.append(hid); e_row.append(i + 1); e_col.append(N - 1)
                    e_src.append(o + i); e_dst.append(o2 + j)
                    e_hmm.append(hid2); e_row.append(0); e_col.append(j + 1)

    asi32 = lambda x: np.asarray(x, np.int32)  # noqa: E731
    return TrainGraph(
        index=index, log_A=log_A, log_entry=log_entry, log_exit=log_exit,
        state_model=state_model,
        e_src=asi32(e_src), e_dst=asi32(e_dst), e_hmm=asi32(e_hmm),
        e_row=asi32(e_row), e_col=asi32(e_col),
        en_state=asi32(en_state), en_hmm=asi32(en_hmm),
        en_row=asi32(en_row), en_col=asi32(en_col),
        ex_state=asi32(ex_state), ex_hmm=asi32(ex_hmm),
        ex_row=asi32(ex_row), ex_col=asi32(ex_col))


def pad_graph(g: TrainGraph, n_states: int, n_edges: int,
              n_entry: int = None, n_exit: int = None) -> TrainGraph:
    """Pad a TrainGraph to fixed shapes so one compiled accumulation
    program serves a whole bucket of transcriptions (and `vmap` can batch
    utterances with different transcriptions).

    Pad states are unreachable (LOG_0 rows/cols, no entry), so their
    occupancies and xi contributions are exactly zero; pad edges connect
    the last pad state to itself and route to transition cell (0, 0, 0),
    whose accumulated value is therefore 0.  ``state_model`` of pad states
    points at model state 0 — harmless because their gamma is 0.
    """
    S = g.n_states
    if n_states < S:
        raise ValueError(f"pad target {n_states} < graph size {S}")
    if n_entry is None:
        n_entry = len(g.en_state)
    if n_exit is None:
        n_exit = len(g.ex_state)

    def padv(v, n, fill):
        out = np.full(n, fill, v.dtype)
        out[: len(v)] = v
        return out

    log_A = np.full((n_states, n_states), LOG_0, np.float32)
    log_A[:S, :S] = g.log_A
    needs_edge_pad = (n_edges > len(g.e_src)
                      or (n_entry or 0) > len(g.en_state)
                      or (n_exit or 0) > len(g.ex_state))
    if needs_edge_pad and n_states == S:
        # pad edges must reference an UNREACHABLE state so their xi/gamma
        # is exactly 0; require at least one pad state when padding edges
        raise ValueError("edge padding requires n_states > graph size "
                         "(pad edges anchor to an unreachable pad state)")
    pad_state = n_states - 1 if n_states > S else 0

    def pad_edges(src, dst, hmm, row, col, n):
        if len(src) > n:
            raise ValueError(f"edge pad target {n} < {len(src)}")
        return (padv(src, n, pad_state), padv(dst, n, pad_state),
                padv(hmm, n, 0), padv(row, n, 0), padv(col, n, 0))

    e = pad_edges(g.e_src, g.e_dst, g.e_hmm, g.e_row, g.e_col, n_edges)
    en = pad_edges(g.en_state, np.zeros(0, np.int32), g.en_hmm, g.en_row,
                   g.en_col, n_entry)
    ex = pad_edges(g.ex_state, np.zeros(0, np.int32), g.ex_hmm, g.ex_row,
                   g.ex_col, n_exit)
    return TrainGraph(
        index=g.index,
        log_A=log_A,
        log_entry=padv(g.log_entry, n_states, LOG_0),
        log_exit=padv(g.log_exit, n_states, LOG_0),
        state_model=padv(g.state_model, n_states, 0),
        e_src=e[0], e_dst=e[1], e_hmm=e[2], e_row=e[3], e_col=e[4],
        en_state=en[0], en_hmm=en[2], en_row=en[3], en_col=en[4],
        ex_state=ex[0], ex_hmm=ex[2], ex_row=ex[3], ex_col=ex[4])
