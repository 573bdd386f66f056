"""Batched, bucketed re-estimation loop on one device.

Counterpart of phnrec_tpu/train/loop.py.  STK trains by looping
utterances through BaumWelchReest one at a time (Viterbi.cc:1124+).  Here:

  1. each utterance's transcription compiles to a graph, PADDED to a bucket
     shape (graph.pad_graph: states/edges rounded up), so that
  2. a bucket's batch of B utterances [B, T, D] accumulates at once: one
     launch of kernel K (Baum-Welch) or K' (Viterbi) over all B, the
     observation GEMMs, einsums and xi products batched over B (the batch
     dimension written out where phnrec_tpu vmaps), and
  3. the summed statistics merge across buckets;
  4. update_ml / update_mmi + apply_update produce the next ModelSet and
     write_mmf persists it.

Bucket keys and ``batch_size`` are phnrec_tpu's, so the two packages sum
the same utterances in the same buckets.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from phnrec_tpu_torch.io.mmf import ModelSet
from phnrec_tpu_torch.train.accum import (Accumulators, accumulate_batch,
                                          make_accumulators,
                                          merge_accumulators, stack_graphs)
from phnrec_tpu_torch.train.graph import (TrainGraph, build_model_index,
                                          compile_transcription, pad_graph)


def _round_up(n: int, m: int) -> int:
    return max(((n + m - 1) // m) * m, m)


@dataclass
class _Bucket:
    graphs: List[TrainGraph]
    xs: List[np.ndarray]
    ns: List[int]
    weights: List[float]


class Reestimator:
    """Accumulates Baum-Welch / Viterbi statistics over batches of
    utterances, one bucket of (S_pad, E_pad, En_pad, Ex_pad, T_pad) shape
    at a time, on ``device``.  ``stage_hook``, when set, is called with a
    stage name after each stage of a bucket flush (a tracing point)."""

    def __init__(self, models: ModelSet, mode: str = "baum_welch",
                 bucket_rounding: int = 32, time_rounding: int = 128,
                 batch_size: int = 16, device="cuda"):
        self.models = models
        self.index = build_model_index(models)
        self.mode = mode
        self.sr = bucket_rounding
        self.tr = time_rounding
        self.batch_size = batch_size
        self.device = torch.device(device)
        self._buckets: Dict[Tuple[int, int, int, int, int], _Bucket] = {}
        self.acc = make_accumulators(self.index, self.device)
        self.total_log_like = 0.0
        self.stage_hook = None

    # -- feeding ---------------------------------------------------------
    def add_utterance(self, x, transcription: Sequence[str],
                      weight: float = 1.0) -> None:
        """``x`` [T, D]: features, or log-posteriors for <PDFObsVec> sets
        (an array, or a tensor on any device)."""
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else x
        g = compile_transcription(self.models, transcription, self.index)
        key = (_round_up(g.n_states + 1, self.sr),
               _round_up(len(g.e_src), 4 * self.sr),
               _round_up(len(g.en_state), self.sr),
               _round_up(len(g.ex_state), self.sr),
               _round_up(x.shape[0], self.tr))
        b = self._buckets.setdefault(key, _Bucket([], [], [], []))
        b.graphs.append(g)
        b.xs.append(np.asarray(x, np.float32))
        b.ns.append(int(x.shape[0]))
        b.weights.append(float(weight))
        if len(b.graphs) >= self.batch_size:
            self._flush_bucket(key)

    def finish(self) -> Accumulators:
        for key in list(self._buckets):
            self._flush_bucket(key)
        return self.acc

    def _mark(self, stage: str) -> None:
        if self.stage_hook is not None:
            self.stage_hook(stage)

    # -- one bucket ------------------------------------------------------
    def _flush_bucket(self, key) -> None:
        b = self._buckets.pop(key, None)
        if b is None or not b.graphs:
            return
        S, E, En, Ex, T = key
        padded = [pad_graph(g, S, E, En, Ex) for g in b.graphs]
        dev = self.device
        gb = stack_graphs(padded, dev)
        D = b.xs[0].shape[1]
        xs = np.zeros((len(b.xs), T, D), np.float32)
        for i, x in enumerate(b.xs):
            xs[i, : x.shape[0]] = x
        ns = torch.tensor(b.ns, dtype=torch.int32, device=dev)
        ws = torch.tensor(b.weights, dtype=torch.float32, device=dev)
        self._mark("bucket_setup")
        upd, ll = accumulate_batch(self.index, gb,
                                   torch.from_numpy(xs).to(dev), ns, ws,
                                   self.mode, mark=self._mark)
        self.acc = merge_accumulators(self.acc, upd)
        self.total_log_like += float(ll.sum())
