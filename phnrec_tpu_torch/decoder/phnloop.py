"""Phoneme-loop Viterbi decoder on torch tensors.

Counterpart of phnrec_tpu/decoder/phnloop.py.  Reference: PhnDec
(phndec.cpp) — a Viterbi over a loop of left-to-right phoneme HMMs with S
states each, self-loop/advance log-probs both log(0.5) (phndec.cpp:9), a
word-insertion penalty on loop re-entry, and — a reference quirk kept for
parity — the insertion penalty already applied at t=0 (phndec.cpp:81-88).

The scan is kernel C (ops/phnloop_viterbi.py), its ragged multi-stream
form kernel C', the device walk back kernel D (ops/backtrack.py) and its
committed-window form kernel D'; on CPU tensors all run their plain
versions.
The host replay ``backtrack`` is the oracle they are held against.  Layouts
are phnrec_tpu's: carry [P, S+1, B], History [T, B], Segments [B, Smax].

Tie-breaking parity:
  * within-model: ``tok_cur > tok_prev`` strictly — ties go to the advancing
    token (phndec.cpp:106),
  * loop argmax: first index wins ties (``tok > max``, phndec.cpp:129).
"""

from __future__ import annotations

import sys
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from phnrec_tpu_torch.io.labels import Label
from phnrec_tpu_torch.ops import backtrack as backtrack_op
from phnrec_tpu_torch.ops import phnloop_viterbi
from phnrec_tpu_torch.utils.profiling import count, span

LOG_0_5 = np.float32(-0.69314718055994530941723212145818)
NEG_INF = np.float32(-np.finfo(np.float32).max)  # -FLT_MAX, phndec.cpp:63


class PhnLoopSpec(NamedTuple):
    n_phonemes: int
    n_states: int            # states per phoneme (decoder/num_states_per_phn)
    w_penalty: float
    log_tr_curr: float = float(LOG_0_5)
    log_tr_next: float = float(LOG_0_5)


class History(NamedTuple):
    """Per-frame loop-node records, TIME-MAJOR: [T] for one utterance,
    [T, B] for a batch.  The winning exit token of each frame is (its
    phoneme, the frame it entered that phoneme, its path score)."""

    max_phn: torch.Tensor    # int8  argmax exit phoneme this frame
    ent: torch.Tensor        # int32 frame at which that token entered
    alpha: torch.Tensor      # f32   winning exit score


def init_carry(spec: PhnLoopSpec, batch: int, device="cpu"):
    """PhnDec::Init state (phndec.cpp:62-88): -FLT_MAX alphas, entry column
    seeded with the insertion penalty (the reference's t=0 quirk).
    Layout [P, S+1, B]."""
    P, S = spec.n_phonemes, spec.n_states
    alphas0 = torch.full((P, S + 1, batch), float(NEG_INF),
                         dtype=torch.float32, device=device)
    alphas0[:, 0, :] = float(np.float32(spec.w_penalty))
    ent0 = torch.zeros((P, S + 1, batch), dtype=torch.int32, device=device)
    return (alphas0, ent0)


def viterbi_block(spec: PhnLoopSpec, carry, log_post: torch.Tensor,
                  t0: int = 0, plain: bool = False):
    """Scan a block of frames from an explicit carry: [B, T, >=P*S] ->
    (carry', History [T, B]).  Phoneme p state s reads log_post[..., p*S+s]
    (CreatePdfIndexes, phndec.cpp:352-368); ``t0`` is the global index of
    the block's first frame.  ``plain`` runs the plain version on any
    device (the reference run)."""
    fn = (phnloop_viterbi.viterbi_block_plain if plain
          else phnloop_viterbi.viterbi_block)
    carry, hist = fn(carry, log_post.contiguous(), int(t0), spec.n_phonemes,
                     spec.n_states, spec.w_penalty, spec.log_tr_curr,
                     spec.log_tr_next)
    return carry, History(*hist)


def viterbi_block_ragged(spec: PhnLoopSpec, carry, log_post: torch.Tensor,
                         t0: torch.Tensor, n_valid: torch.Tensor):
    """Per-row masked block scan for multi-stream serving: row b is a
    stream at global frame t0[b] with n_valid[b] real frames this block;
    past them its carry passes through and its History rows are undefined
    (the caller tracks validity).  [B, T, >=P*S] -> (carry', History
    [T, B])."""
    dev = log_post.device
    carry, hist = phnloop_viterbi.viterbi_block_ragged(
        carry, log_post.contiguous(),
        t0.to(device=dev, dtype=torch.int32).contiguous(),
        n_valid.to(device=dev, dtype=torch.int32).contiguous(),
        spec.n_phonemes, spec.n_states, spec.w_penalty, spec.log_tr_curr,
        spec.log_tr_next)
    return carry, History(*hist)


def viterbi_scan_batch(spec: PhnLoopSpec, log_post: torch.Tensor,
                       plain: bool = False) -> History:
    """Whole-utterance batch decode: [B, T, >=P*S] -> History [T, B]."""
    carry = init_carry(spec, log_post.shape[0], log_post.device)
    return viterbi_block(spec, carry, log_post, plain=plain)[1]


def viterbi_scan(spec: PhnLoopSpec, log_post: torch.Tensor,
                 plain: bool = False) -> History:
    """Single-utterance wrapper: [T, >=P*S] -> History arrays [T]."""
    hist = viterbi_scan_batch(spec, log_post[None], plain=plain)
    return History(*(a[:, 0] for a in hist))


def backtrack(hist: History, phonemes: List[str]) -> List[Label]:
    """Full-history replay of PhnDec::Done (phndec.cpp:236-302) on the
    host: the oracle of the device walk."""
    return backtrack_committed(hist, 0, 0, 0.0, phonemes)


def backtrack_committed(hist: History, row_offset: int, frame0: int,
                        alpha0: float, phonemes: List[str]) -> List[Label]:
    """backtrack() over a retained history window whose row i is global
    frame ``row_offset + i``; the walk stops at ``frame0``, clamping the
    earliest label's start to it, and uses ``alpha0`` as the boundary's
    cumulative like (phndec.cpp:191-234).  Copy of phnrec_tpu's."""
    max_phn = np.asarray(hist.max_phn)
    ent = np.asarray(hist.ent)
    alpha = np.asarray(hist.alpha)
    T = max_phn.shape[0]
    end = row_offset + T
    labels: List[Label] = []
    while end > frame0:
        i = end - 1 - row_offset
        phn = int(max_phn[i])
        if phn < 0:
            break
        start = max(int(ent[i]), frame0)     # forced-commit clamp
        prev_alpha = (alpha0 if start <= frame0
                      else float(alpha[start - 1 - row_offset]))
        labels.append(Label(start, end, phonemes[phn],
                            float(alpha[i]) - prev_alpha))
        end = start
    labels.reverse()
    return labels


def commit_labels(labels: List[Label], horizon_end: int,
                  like_at_horizon: Callable[[], float]):
    """The fixed-lag commit policy of one stream.  ``labels`` is the
    backtrack of its retained window in time order, likes relative to the
    committed boundary (alpha0 = 0).  Labels ending by ``horizon_end``
    commit; if none does, the label spanning the horizon is split there,
    like the reference's ring (a forced commit), with the like
    ``like_at_horizon()``, the path's at frame horizon_end - 1.  Returns
    (labels to commit, the new boundary frame, its like: the committed
    likes telescope), or None when nothing commits."""
    commit = [l for l in labels if l.end_frames <= horizon_end]
    if not commit:
        if not labels or labels[0].start_frames >= horizon_end:
            return None
        l0 = labels[0]
        commit = [Label(l0.start_frames, horizon_end, l0.name,
                        float(like_at_horizon()))]
    return commit, commit[-1].end_frames, float(sum(l.score for l in commit))


class Columns(NamedTuple):
    """Labels as arrays, each row's in time order, phonemes as ids into
    the phoneme list: padded, row b's ``count[b]`` labels in the first
    slots of [B, K] (slots past them undefined), or flat, [count.sum()]
    row after row."""

    count: np.ndarray        # [B] int64
    start: np.ndarray        # int64 start frame
    end: np.ndarray          # int64 end frame
    phn: np.ndarray          # int8 phoneme id
    like: np.ndarray         # float64


def columns_from_segments(segs: Segments, n_frames: np.ndarray,
                          row_offset: "np.ndarray | None" = None
                          ) -> Columns:
    """labels_from_segments' arithmetic, stopped before any Label is made:
    the segments (reverse time order) as Columns in time order, frames,
    ids and likes exactly those of labels_from_segments' Labels, padded.
    Span ``labels.columns``."""
    with span("labels.columns"):
        counts = np.asarray(segs.count).astype(np.int64)
        K = int(counts.max(initial=0))
        # slot K, where a row of K segments reads its zero past the count
        W = min(K + 1, segs.start.shape[1])
        start = np.asarray(segs.start[:, :W], dtype=np.int64)
        if row_offset is not None:
            start = start + np.asarray(row_offset, np.int64)[:, None]
        alpha_end = np.asarray(segs.alpha_end[:, :W], dtype=np.float64)
        B = counts.shape[0]
        likes = alpha_end - np.concatenate(
            [alpha_end[:, 1:], np.zeros((B, 1))], 1)
        ends = np.concatenate(
            [np.asarray(n_frames, dtype=np.int64)[:, None], start[:, :-1]],
            1)
        # time slot j of row b is segment slot count[b] - 1 - j
        slot = np.clip(counts[:, None] - 1 - np.arange(K)[None, :], 0,
                       W - 1)
        take = lambda a: np.take_along_axis(a, slot, 1)  # noqa: E731
        return Columns(counts, take(start), take(ends),
                       take(np.asarray(segs.phn[:, :W])), take(likes))


def commit_columns(cols: Columns, horizon_end: np.ndarray,
                   like_at_horizon: np.ndarray):
    """commit_labels on every row of padded ``cols`` at once, bit for
    bit: labels ending by ``horizon_end[b]`` commit; a row where none does
    and whose first label starts before it commits that label split
    there, with the like ``like_at_horizon[b]``.  Returns (the committed
    labels as flat Columns; the new boundary frames [B] and their likes
    [B], the committed likes summed as Python's ``sum`` adds them; both
    valid where a row commits)."""
    B, K = cols.start.shape
    if K == 0:
        z = np.zeros(B, np.int64)
        return Columns(z, *(a.ravel() for a in cols[1:])), z, np.zeros(B)
    take = ((np.arange(K)[None, :] < cols.count[:, None])
            & (cols.end <= horizon_end[:, None]))
    n = take.sum(1)
    end, like = cols.end, cols.like
    forced = (n == 0) & (cols.count > 0)
    forced[forced] = cols.start[forced, 0] < horizon_end[forced]
    if forced.any():
        end, like = end.copy(), like.copy()
        end[forced, 0] = horizon_end[forced]
        like[forced, 0] = like_at_horizon[forced]
        take[forced, 0] = True
        n = n + forced
    last = K - 1 - np.argmax(take[:, ::-1], axis=1)
    frame0 = np.take_along_axis(end, last[:, None], 1)[:, 0]
    # the labels left out add 0.0, which changes no sum
    alpha0 = _python_sums(np.where(take, like, 0.0)[
        :, : int(last[n > 0].max(initial=-1)) + 1])
    return (Columns(n, cols.start[take], end[take], cols.phn[take],
                    like[take]), frame0, alpha0)


def _python_sums(x: np.ndarray) -> np.ndarray:
    """``sum(row)`` of each row of a float64 [B, K] array, bit for bit as
    the interpreter adds Python floats: left to right from 0, and from
    Python 3.12 with Neumaier's compensation (so neither numpy's
    sequential ``cumsum`` nor its pairwise ``sum`` gives it)."""
    f = np.zeros(x.shape[0])
    if sys.version_info < (3, 12):
        for j in range(x.shape[1]):
            f = f + x[:, j]
        return f
    c = np.zeros(x.shape[0])
    for j in range(x.shape[1]):
        xj = x[:, j]
        t = f + xj
        c += np.where(np.abs(f) >= np.abs(xj), (f - t) + xj, (xj - t) + f)
        f = t
    return np.where((c != 0) & np.isfinite(c), f + c, f)


def backtrack_batch(hist: History, n_frames: np.ndarray,
                    phonemes: List[str]) -> List[List[Label]]:
    """Host replay over [T, B] histories (columns valid up to
    n_frames[b]): one call of the native C++ walk for the whole batch where
    the native library builds (phnrec_tpu_torch/native), else the per-row
    Python replay; the two give identical labels, scores included."""
    from phnrec_tpu_torch import native

    max_phn, ent, alpha = (
        np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
        for a in hist)
    if max_phn.ndim != 2:
        raise ValueError("backtrack_batch expects [T, B] histories")
    T = max_phn.shape[0]
    if native.available() and T > 0:
        # the native walk reads the (prev_phn, length) form in [B, T]
        length = np.arange(T, dtype=np.int64)[:, None] - ent + 1
        prev_phn = np.where(ent > 0, np.take_along_axis(
            max_phn.astype(np.int32), np.maximum(ent - 1, 0), axis=0), -1)
        segs = native.backtrack_batch(
            max_phn.T.astype(np.int32), prev_phn.T.astype(np.int32),
            length.T.astype(np.int32), alpha.T, np.asarray(n_frames))
        # the likes as the Python replay takes them, float64 differences
        # of the float32 alphas (the native walk rounds them to float32)
        a64 = alpha.astype(np.float64)
        out = []
        for b, (st, en, ph, _) in enumerate(segs):
            likes = a64[en - 1, b] - np.where(
                st > 0, a64[np.maximum(st - 1, 0), b], 0.0)
            out.append(list(map(Label, st.tolist(), en.tolist(),
                                [phonemes[i] for i in ph], likes.tolist())))
        return out
    return [backtrack(History(*(a[: int(n_frames[b]), b]
                                for a in (max_phn, ent, alpha))), phonemes)
            for b in range(max_phn.shape[1])]


def decode(spec: PhnLoopSpec, log_post: torch.Tensor,
           phonemes: List[str]) -> List[Label]:
    """One utterance's log-posteriors [T, >=P*S] -> labels: the scan
    (kernel C at B 1 on the card) and the host replay."""
    return backtrack(History(*(a.cpu() for a in
                               viterbi_scan(spec, log_post))), phonemes)


class Segments(NamedTuple):
    """Compacted backtrack output, segments in REVERSE time order (segment
    0 ends at n_frames).  Shapes [B] / [B, Smax]."""

    count: torch.Tensor      # [B] number of valid segments
    phn: torch.Tensor        # [B, Smax] int8 phoneme id
    start: torch.Tensor      # [B, Smax] start frame
    alpha_end: torch.Tensor  # [B, Smax] path score at the segment's last frame


def max_segments(spec: PhnLoopSpec, max_frames: int) -> int:
    """A settled phoneme traverses all S emitting states, one frame each
    minimum, so T frames hold at most T//S segments (+1 for the t=0
    entry quirk)."""
    return max_frames // spec.n_states + 1


def backtrack_device(spec: PhnLoopSpec, hist: History,
                     n_frames: torch.Tensor, plain: bool = False,
                     smax: Optional[int] = None) -> Segments:
    """PhnDec::Done (phndec.cpp:236-302) on the device: at most T//S + 1
    hops per utterance, emitted as compact Segments so only ~7 bytes per
    segment leave the device.  ``plain`` runs the plain version on any
    device (the reference run).  ``smax`` overrides the slots a row,
    ``max_segments`` of the History's T: a row of T < S frames fills those
    T//S + 1 slots, which ``fetch_segments`` takes for a truncated walk."""
    T = hist.max_phn.shape[0]
    if T >= 1 << 20:
        raise ValueError("backtrack_device packs entry frames in 20 bits")
    fn = backtrack_op.backtrack_plain if plain else backtrack_op.backtrack
    n_frames = n_frames.to(device=hist.max_phn.device, dtype=torch.int32)
    return Segments(*fn(hist.max_phn.contiguous(), hist.ent.contiguous(),
                        hist.alpha.contiguous(), n_frames.contiguous(),
                        smax or max_segments(spec, T)))


def backtrack_device_committed(spec: PhnLoopSpec, hist: History,
                               n_frames: torch.Tensor, frame0: torch.Tensor,
                               row_offset: torch.Tensor) -> Segments:
    """backtrack_device over a retained window: row i of ``hist`` is
    global frame row_offset[b] + i of stream b; the walk stops at the
    committed boundary frame0[b] (global), clamping the earliest segment's
    start to it.  History.ent is global and is rebased to window rows in
    the walk, so the 20-bit packing limit bounds only the window.  Starts
    come out window-relative (labels_from_segments adds row_offset back);
    ``n_frames`` counts window rows."""
    T = hist.max_phn.shape[0]
    if T >= 1 << 20:
        raise ValueError("backtrack_device packs entry frames in 20 bits")
    dev = hist.max_phn.device
    i32 = lambda t: t.to(device=dev, dtype=torch.int32).contiguous()  # noqa
    return Segments(*backtrack_op.backtrack_committed(
        hist.max_phn.contiguous(), hist.ent.contiguous(),
        hist.alpha.contiguous(), i32(n_frames), i32(frame0),
        i32(row_offset), max_segments(spec, T)))


def fetch_segments_start(segs: Segments, cap: int = 128):
    """Begin the device -> host copy of a Segments batch: every leaf,
    ``count`` included, is sliced on the device to ``min(Smax, cap)`` slots
    (the static T//S + 1 bound is ~5x what speech needs) and copied into
    pinned host tensors with ``non_blocking=True``, and a CUDA event marks
    the copies' end, so the host can go on (build the previous batch's
    labels, enqueue the next batch) while they run.  On CPU tensors it is
    just the slice.  ``fetch_segments_finish`` completes it."""
    k = min(segs.phn.shape[1], cap)
    small = Segments(segs.count, *(a[:, :k] for a in segs[1:]))
    if segs.count.device.type != "cuda":
        return segs, small, None
    host = Segments(*(torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
                      for a in small))
    for h, a in zip(host, small):
        h.copy_(a, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return segs, host, done


def fetch_segments_finish(pending) -> Segments:
    """Wait for ``fetch_segments_start``'s copies and return the Segments
    as numpy arrays; a row holding more than the sliced slots is refetched
    at full width.  Raises if a row's count reached the Smax capacity,
    which would mean the walk truncated it.  Span ``fetch.wait``: the wait
    and any refetch."""
    segs, small, done = pending
    with span("fetch.wait"):
        if done is not None:
            done.synchronize()
        counts = small.count.numpy()
        out = Segments(counts, *(a.numpy() for a in small[1:]))
        smax = segs.phn.shape[1]
        cmax = int(counts.max(initial=0))
        if cmax > out.phn.shape[1]:
            out = Segments(counts, *(a.cpu().numpy() for a in segs[1:]))
    if smax and cmax >= smax:
        raise AssertionError(
            f"backtrack capacity overflow: count {cmax} reached Smax {smax}")
    return out


def fetch_segments(segs: Segments, cap: int = 128) -> Segments:
    """Device -> host copy of a Segments batch as numpy arrays (see
    fetch_segments_start): sliced to ``cap`` slots, refetched at full
    width only if a row holds more."""
    return fetch_segments_finish(fetch_segments_start(segs, cap))


def labels_from_segments(segs: Segments, n_frames: np.ndarray,
                         phonemes: List[str],
                         row_offset: "np.ndarray | None" = None
                         ) -> List[List[Label]]:
    """Host-side formatting of backtracked segments (reverse time order)
    into per-utterance Label lists.  Segment j's end frame is segment
    j-1's start (j=0 ends at n_frames); its like is the alpha delta to the
    previous-in-time segment (initial mPrevAlpha = 0).  Copy of
    phnrec_tpu's.  Span ``labels.build``, counter ``labels.built``."""
    with span("labels.build") as traced:
        counts = np.asarray(segs.count)
        start = np.asarray(segs.start, dtype=np.int64)
        if row_offset is not None:
            start = start + np.asarray(row_offset, np.int64)[:, None]
        alpha_end = np.asarray(segs.alpha_end, dtype=np.float64)
        B = counts.shape[0]
        # like[j] = alpha_end[j] - alpha_end[j+1] in emission order; slots
        # past count are zero, so the first-in-time segment subtracts the
        # initial mPrevAlpha = 0.  end[j] = start[j-1] (j=0 ends at
        # n_frames).
        likes = alpha_end - np.concatenate(
            [alpha_end[:, 1:], np.zeros((B, 1))], 1)
        ends = np.concatenate(
            [np.asarray(n_frames, dtype=np.int64)[:, None], start[:, :-1]],
            1)
        names = np.asarray(phonemes, dtype=object)[np.asarray(segs.phn)]
        if traced is not None:
            count("labels.built", int(counts.sum()))
        return [
            list(map(Label, start[b, k - 1 :: -1].tolist(),
                     ends[b, k - 1 :: -1].tolist(),
                     names[b, k - 1 :: -1].tolist(),
                     likes[b, k - 1 :: -1].tolist())) if k else []
            for b, k in enumerate(counts.tolist())
        ]
