"""Hypothesis/reference alignment and HResults-style scoring.

The reference computed accuracies externally with HTK HResults (the
results.txt files in each package); STKLib carries the same alignment
primitive (AlingTranscriptions, labels.C:555+) with HTK's standard edit
costs: substitution 10, insertion 7, deletion 7 (labels.C:525-527).
This module makes the evaluation self-contained: align label sequences,
count H/D/S/I, and report %Corr = H/N and Acc = (H-I)/N like HResults.
Copy of phnrec_tpu/score.py on the port's native module.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

SUB_COST, INS_COST, DEL_COST = 10, 7, 7


@dataclass
class AlignmentCounts:
    hits: int = 0
    dels: int = 0
    subs: int = 0
    ins: int = 0

    @property
    def n_ref(self) -> int:
        return self.hits + self.dels + self.subs

    @property
    def pct_correct(self) -> float:
        return 100.0 * self.hits / self.n_ref if self.n_ref else 0.0

    @property
    def accuracy(self) -> float:
        return 100.0 * (self.hits - self.ins) / self.n_ref \
            if self.n_ref else 0.0

    def __iadd__(self, other: "AlignmentCounts") -> "AlignmentCounts":
        self.hits += other.hits
        self.dels += other.dels
        self.subs += other.subs
        self.ins += other.ins
        return self


def align(ref: Sequence[str], hyp: Sequence[str]
          ) -> Tuple[AlignmentCounts, List[Tuple[Optional[str],
                                                 Optional[str]]]]:
    """Minimum-edit-cost alignment with HTK costs.

    Returns counts and the aligned pair list [(ref_sym|None, hyp_sym|None)].
    """
    R, H = len(ref), len(hyp)
    INF = 1 << 60
    cost = [[0] * (H + 1) for _ in range(R + 1)]
    back = [[0] * (H + 1) for _ in range(R + 1)]   # 0=diag 1=del 2=ins
    for i in range(1, R + 1):
        cost[i][0] = i * DEL_COST
        back[i][0] = 1
    for j in range(1, H + 1):
        cost[0][j] = j * INS_COST
        back[0][j] = 2
    for i in range(1, R + 1):
        for j in range(1, H + 1):
            sub = cost[i - 1][j - 1] + (0 if ref[i - 1] == hyp[j - 1]
                                        else SUB_COST)
            dele = cost[i - 1][j] + DEL_COST
            ins = cost[i][j - 1] + INS_COST
            best = min(sub, dele, ins)
            cost[i][j] = best
            back[i][j] = 0 if best == sub else (1 if best == dele else 2)

    pairs: List[Tuple[Optional[str], Optional[str]]] = []
    counts = AlignmentCounts()
    i, j = R, H
    while i > 0 or j > 0:
        b = back[i][j]
        if b == 0 and i > 0 and j > 0:
            pairs.append((ref[i - 1], hyp[j - 1]))
            if ref[i - 1] == hyp[j - 1]:
                counts.hits += 1
            else:
                counts.subs += 1
            i, j = i - 1, j - 1
        elif b == 1 and i > 0:
            pairs.append((ref[i - 1], None))
            counts.dels += 1
            i -= 1
        else:
            pairs.append((None, hyp[j - 1]))
            counts.ins += 1
            j -= 1
    pairs.reverse()
    return counts, pairs


def align_counts(ref: Sequence[str], hyp: Sequence[str]) -> AlignmentCounts:
    """Counts-only alignment; dispatches to the native C++ DP kernel
    (native/src/phnrec_native.cpp pn_align) when built.  Same costs and
    backpointer tie order as align() — results are identical."""
    from phnrec_tpu_torch import native

    if native.available():
        import numpy as np
        syms: Dict[str, int] = {}
        rid = [syms.setdefault(s, len(syms)) for s in ref]
        hid = [syms.setdefault(s, len(syms)) for s in hyp]
        h, d, s, i = native.align(np.asarray(rid, np.int32),
                                  np.asarray(hid, np.int32))
        return AlignmentCounts(hits=h, dels=d, subs=s, ins=i)
    counts, _ = align(ref, hyp)
    return counts


@dataclass
class Scorer:
    """Accumulates counts across utterances; prints an HResults-like
    summary line."""

    total: AlignmentCounts = field(default_factory=AlignmentCounts)
    n_utts: int = 0
    n_correct_utts: int = 0

    def add(self, ref: Sequence[str], hyp: Sequence[str]) -> AlignmentCounts:
        counts = align_counts(ref, hyp)
        self.total += counts
        self.n_utts += 1
        if counts.subs == counts.dels == counts.ins == 0:
            self.n_correct_utts += 1
        return counts

    def summary(self) -> str:
        t = self.total
        sent_corr = (100.0 * self.n_correct_utts / self.n_utts
                     if self.n_utts else 0.0)
        return (
            f"SENT: %Correct={sent_corr:.2f} "
            f"[H={self.n_correct_utts}, N={self.n_utts}]\n"
            f"WORD: %Corr={t.pct_correct:.2f}, Acc={t.accuracy:.2f} "
            f"[H={t.hits}, D={t.dels}, S={t.subs}, I={t.ins}, N={t.n_ref}]")


def score_mlf(ref_mlf: str, hyp_mlf: str) -> Scorer:
    """Score one MLF against another (names matched by basename stem)."""
    import os

    from phnrec_tpu_torch.io.labels import read_mlf

    def stem(name: str) -> str:
        return os.path.splitext(os.path.basename(name.strip("*/")))[0]

    refs = {stem(k): [l.name for l in v]
            for k, v in read_mlf(ref_mlf).items()}
    hyps = {stem(k): [l.name for l in v]
            for k, v in read_mlf(hyp_mlf).items()}
    scorer = Scorer()
    for k, ref in refs.items():
        if k in hyps:
            scorer.add(ref, hyps[k])
    return scorer
