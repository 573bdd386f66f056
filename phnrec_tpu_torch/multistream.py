"""Multi-stream streaming recognition: N concurrent audio streams decoded
through ONE fused block per step, on one torch device.

Counterpart of phnrec_tpu/multistream.py.  Per block the streams run
together through

    span [N, samples] -> mel -> online norm -> LCRC context windows
    -> band + merger MLPs (kernel A) -> softening -> the subclass's
    masked decoder block

with the stream axis leading every carried tensor (mel tails, online-norm
sums, decoder carry).  Streams advance unevenly: row b of a block holds
v[b] new frames, rows past them are padding that the decoder masks.  The
JAX package's "one jitted program" per block is one Python function over
device tensors here (``_fused_impl``), and its scan over the blocks of a
device-resident buffer is a Python loop over blocks
(``decode_device_buffer``).

``MultiStreamRecognizer`` itself serves the phoneme loop: the masked
decoder block is the ragged scan (kernel C'), results() walks the history
back on the device (kernel D) when every stream advanced alike and replays
each stream on the host otherwise, and the opt-in fixed-lag commit
(``commit_horizon``) walks the retained window on the device (kernel D')
in lockstep steady state.  ``MultiStreamKWS`` serves keyword spotting (the
stkint KWS chain), ``MultiStreamStkDecode`` stkint decoding with fixed-lag
word emission.

``mesh`` (a DeviceMesh with a "data" dimension, parallel/mesh.py) shards
the streams SPMD, one process per card, as phnrec_tpu's ``P("data")``
shards its stream axis: every rank makes the same calls, holds the
carries, buffers and History of its contiguous rows (n_streams must
divide by the group's size) and launches the kernels on them alone.  The
host bookkeeping of every stream (its pending sample count, frames seen,
frames decoded, ended) is kept on every rank, so each rank takes the same
pump and commit decisions as the unsharded server; ``process(i, ...)``
for another rank's stream only advances that bookkeeping.
``shard_audio`` returns this rank's rows of an [N, L] buffer on its card.
``results()`` and ``finish()`` all-gather the label lists, so every rank
returns all N streams.  With ``commit_horizon`` (and in
MultiStreamStkDecode) each rank drops its History blocks by its own rows'
commits, so the retained memory is per rank; the commit trigger reads the
blocks every rank has dropped (one all-reduce a commit), so the commits,
and the labels, are the unsharded run's.
"""

from __future__ import annotations

import itertools
from typing import List, Optional

import numpy as np
import torch

from phnrec_tpu_torch import normalization
from phnrec_tpu_torch.decoder import phnloop
from phnrec_tpu_torch.decoder.stknet import (
    NEG, OFF_BEAM, DenseKWSScan, decode_lrtrace_events,
    flush_outstanding_candidates, lrtrace_init_state)
from phnrec_tpu_torch.io.labels import Label
from phnrec_tpu_torch.io.normfile import save_norm_file
from phnrec_tpu_torch.io.xform import (apply_instance_stateful_ragged,
                                       instance_init_state)
from phnrec_tpu_torch.ops import lrtrace, netdecode, netstep
from phnrec_tpu_torch.streaming import _convert_chunk, _make_posterior_block_fn
from phnrec_tpu_torch.utils import collector, profiling

# the dense network steps (kernels B and E) take networks of at most this
# many models + states, as JAX's dense scans do (phnrec_tpu/multistream.py:
# 1042, 1300); bigger ones run the edge-list scan (kernel G)
DENSE_MAX = 1024
# servers made in this process: the serving feed's request ids
_SERVERS = itertools.count()

class MultiStreamRecognizer:
    """Decode ``n_streams`` independent audio streams in lockstep-batched
    fused blocks.  Feed bytes with process(i, raw), which pumps fused
    blocks when streams have audio (or call pump() with auto_pump off), or
    samples already on the device with decode_device_buffer,
    dispatch_block_device or dispatch_from_device_buffer; finish() flushes
    tails and returns per-stream label lists.  ``stage_hook``, when set,
    is called with a stage name after each stage of a block and of
    results() (a tracing point; chip_smoke.py records CUDA events
    there).  Traced (utils/profiling.py): spans ``serve.round`` a
    dispatch (request id (the server's number, its round)),
    ``serve.launch`` a fused block, ``serve.commit`` a commit with
    ``fetch.wait`` (its waits on the card), ``labels.columns``,
    ``serve.commit_streams`` and ``serve.rebase`` inside, counters
    ``serve.commits`` and ``labels.kept`` (the labels committed as
    arrays), and ``serve.finish``."""

    def __init__(self, sr, n_streams: int, block_frames: int = 128,
                 auto_pump: bool = True, mesh=None,
                 commit_horizon: Optional[int] = None,
                 partial_pump: bool = False):
        """``auto_pump``: process() pumps fused blocks itself; with False
        the caller pumps.  ``partial_pump``: dispatch a block as soon as
        ANY live stream has a full block pending, the others contributing
        what they have (idle rows pass their carry through), so one slow
        stream does not stall the rest; the default lockstep policy waits
        for every live stream to fill a block.

        ``commit_horizon`` (phoneme loop): opt-in fixed-lag commit for
        unbounded sessions.  Labels ending at least that many frames behind
        a stream's newest frame are committed and their history blocks
        dropped once every stream's rows in them are committed (the
        reference's TimePruning ring, phndec.cpp:191-234), so the retained
        history is O(horizon), not O(session).  A label spanning the
        horizon is split there (its like telescopes exactly), and committed
        scores are rebased out of the carry so float32 stays healthy over
        long sessions.  None keeps the whole history."""
        if sr.estimator is None:
            raise ValueError("streaming requires an enabled estimator")
        self._check_decoder(sr)
        self.commit_horizon = commit_horizon
        self.online_norm = normalization.OnlineNorm.from_config(
            sr.cfg, sr.frontend.spec.nbanks)
        self.sr = sr
        self.device = dev = sr.device
        self.n = n_streams
        self._axis = None
        lo, hi = 0, n_streams
        if mesh is not None:
            from phnrec_tpu_torch.parallel.mesh import data_axis, rows_of
            self._axis = data_axis(mesh)
            if n_streams % self._axis.size:
                raise ValueError("n_streams must divide the mesh's "
                                 "'data' axis size")
            lo, hi = rows_of(n_streams, self._axis)
        # this rank's streams: device tensors and per-row decoder state
        # hold rows lo..hi-1 (all of them without a mesh)
        self._lo, self._rows, nl = lo, slice(lo, hi), hi - lo
        self._nl = nl
        self.block = block_frames
        spec = sr.frontend.spec
        self.vs, self.step_len = spec.vector_size, spec.step
        self.nbanks = spec.nbanks
        self.trap_shift = s = sr.estimator.trap_shift
        self.auto_pump = auto_pump
        self.partial_pump = partial_pump
        self.stage_hook = None
        self._server, self._round = next(_SERVERS), 0

        self._i16 = (sr.wave_format == "lin16" and sr.wave_noise == 0.0)
        dtype = np.int16 if self._i16 else np.float32
        # samples of this rank's streams; pending sample counts of all
        self._bufs = [np.zeros(0, dtype) for _ in range(n_streams)]
        self._buf_len = np.zeros(n_streams, np.int64)
        self._byte_rem = [b"" for _ in range(n_streams)]
        self._ended = np.zeros(n_streams, bool)
        self._n_mel = np.zeros(n_streams, np.int64)
        self._n_dec = np.zeros(n_streams, np.int64)
        self._primed_host = np.zeros(n_streams, bool)
        self._flushed = False

        self._mel_tail = torch.zeros((nl, 2 * s, self.nbanks), device=dev)
        self._primed = torch.zeros((nl,), dtype=torch.bool, device=dev)
        self._carry = self._init_decode_carry()
        # per dispatch: (block output on the device, valid rows [N] np)
        self._hist: List = []
        # fixed-lag commit state (commit_horizon), this rank's rows: the
        # committed labels as arrays, flat Columns a commit, until
        # results() makes them into each stream's Labels (_made); the
        # boundary frames, path like at the boundary, and the global
        # frame of each stream's first retained history row
        self._kept: List[phnloop.Columns] = []
        self._made: List[List[Label]] = [[] for _ in range(nl)]
        self._frame0 = np.zeros(nl, np.int64)
        self._alpha0 = np.zeros(nl, np.float64)
        self._row_offset = np.zeros(nl, np.int64)
        # with a mesh: the valid counts [N] of the blocks not yet dropped
        # by every rank, and every stream's offset past the dropped ones
        # (the unsharded server's row offsets, for the commit trigger)
        self._n_dropped = 0
        self._g_valid: List[np.ndarray] = []
        self._g_row_offset = np.zeros(n_streams, np.int64)

        # -- device-carried online normalization (norm.cpp:92-234): each
        # stream accumulates its first estim_interval mel frames, then
        # freezes and normalizes from the frame COMPLETING the estimate
        # onward; estim_interval == 0 applies file-loaded channel params
        on = self.online_norm
        on.set_channel(sr.cfg.get_int("onlinenorm", "channel"))
        self._on_E = on.estim_interval
        ch = on._state(on.cur)
        self._on_mean0 = torch.tensor(ch["mean"], device=dev)
        self._on_inv0 = torch.tensor(
            ch["inv_std"] * (ch["glob_std"] if on.scale_to_gvar else 1.0),
            dtype=torch.float32, device=dev)
        self._on_gstd = torch.tensor(ch["glob_std"], device=dev)
        self._onorm_state = () if not on.enabled or self._on_E == 0 else (
            torch.zeros((nl,), dtype=torch.int32, device=dev),
            torch.zeros((nl, self.nbanks), device=dev),
            torch.zeros((nl, self.nbanks), device=dev))

        # the LCRC taps as a per-stream window gather at every stream
        # count: on the H100 at block 512 it takes 0.94x the depthwise-conv
        # form's time from 64 to 256 streams, the same at 16-32 and at most
        # 0.08 ms more below, for 1.4x its memory (PERF.md)
        self._post_fn = _make_posterior_block_fn(sr)

    # -- decoder hooks (overridden by the stkint subclasses) -------------
    def _check_decoder(self, sr) -> None:
        if sr.stk_decoder is not None:
            raise ValueError(
                "MultiStreamRecognizer serves the phnloop decoder; for "
                "stkint packages use MultiStreamStkDecode (decode mode) or "
                "MultiStreamKWS (kws mode)")

    def _init_decode_carry(self):
        return phnloop.init_carry(self.sr.loop_spec, self._nl, self.device)

    # -- the global <InputXform>'s delay lines (stkint subclasses) -------
    # The reference applies it per frame with live delay-line memory
    # (ModelSet::UpdateStacks from every ViterbiStep, Viterbi.cc:2068):
    # each stream carries its stacking FIFOs [N, K-1, D] in the decode
    # carry and advances them by exactly its valid rows of a block.
    _xform_inst = None

    def _xform_state0(self):
        if self._xform_inst is None:
            return ()
        return instance_init_state(self._xform_inst, (self._nl,),
                                   self.device)

    def _apply_xform(self, xst, lp, n_valid):
        """The stateful InputXform over a ragged block [N, F, D]: rows >=
        n_valid[b] of stream b are padding and do not advance its delay
        lines (one gather over the [N] streams, no loop)."""
        if self._xform_inst is None:
            return xst, lp
        return apply_instance_stateful_ragged(self._xform_inst, xst, lp,
                                              n_valid)

    def _decode_block(self, carry, lp, n_dec, n_valid):
        """(decode carry, rolled log-posteriors [N, F, D], per-row global
        frame offsets, per-row valid counts) -> (carry', History [F, N]):
        one launch of the ragged scan.  (The JAX package's unroll choice
        by stream count is a TPU matter; the kernel has no unroll.)"""
        out = phnloop.viterbi_block_ragged(self.sr.loop_spec, carry, lp,
                                           n_dec, n_valid)
        self._mark("viterbi")
        return out

    def _compact_scan(self, hists, skip0, K: int, N: int):
        """Merge the block outputs of one decode_device_buffer run into one
        History: rows were rolled valid-first per block and only the first
        block of a fresh stream skips (the delay gate), so one gather
        removes the gap at the end of block 0's section."""
        merged = [torch.cat([h[j] for h in hists], dim=0) for j in range(3)]
        if skip0.any():
            TT = K * self.block
            j = torch.arange(TT, device=self.device)[:, None]
            sk = torch.as_tensor(skip0, device=self.device)[None, :]
            idx = torch.clamp(j + torch.where(j >= self.block - sk, sk, 0),
                              0, TT - 1)
            merged = [torch.gather(a, 0, idx) for a in merged]
        self._mark("compact")
        return phnloop.History(*merged)

    def _mark(self, stage: str) -> None:
        if self.stage_hook is not None:
            self.stage_hook(stage)

    # -- the fused block -------------------------------------------------
    def _front(self, span: torch.Tensor) -> torch.Tensor:
        """[N, samples] int16 or float -> [N, F, nb] normalized mel."""
        sr = self.sr
        w = span.to(torch.float32)
        if self._i16 and sr.wave_dc_shift != 0.0:
            w = w + torch.tensor(sr.wave_dc_shift, dtype=torch.float32)
        if self._i16 and sr.wave_scale != 1.0:
            w = w * torch.tensor(sr.wave_scale, dtype=torch.float32)
        F = (span.shape[1] - self.vs) // self.step_len + 1
        par = sr.frontend(w, F)
        return normalization.frame_norm(par, sr.frame_shift, sr.frame_floor)

    def _onorm(self, par, v, n_mel, onst):
        """[N, F, nb] mel rows (row j of stream b = global mel frame
        n_mel[b] + j; rows >= v[b] garbage) -> normalized rows + advanced
        estimation state."""
        on = self.online_norm
        if not on.enabled:
            return par, onst
        if self._on_E == 0:                # frozen file-loaded params
            out = par
            if on.mean_norm:
                out = out - self._on_mean0
            if on.var_norm:
                out = out * self._on_inv0
            return out, onst
        E = self._on_E
        cnt, sx, sxx = onst
        F = par.shape[1]
        ar = torch.arange(F, dtype=torch.int32, device=par.device)
        g = n_mel[:, None] + ar[None, :]
        contrib = ((g < E) & (ar[None, :] < v[:, None]))[:, :, None]
        sx = sx + torch.sum(torch.where(contrib, par, 0.0), dim=1)
        sxx = sxx + torch.sum(torch.where(contrib, par * par, 0.0), dim=1)
        cnt = cnt + torch.sum(contrib[:, :, 0], dim=1, dtype=torch.int32)
        mean = sx / float(E)
        var = torch.clamp(sxx / float(E) - mean * mean, min=1e-20)
        inv = torch.rsqrt(var)
        if on.scale_to_gvar:
            inv = inv * self._on_gstd
        out = par
        if on.mean_norm:
            out = out - mean[:, None, :]
        if on.var_norm:
            out = out * inv[:, None, :]
        apply_row = (g >= E - 1)[:, :, None]
        return torch.where(apply_row, out, par), (cnt, sx, sxx)

    def _decode_ctx(self, ctx, skip, carry, n_dec, n_valid, cap: int):
        """Posterior rows from the per-stream context, rolled so each row's
        valid frames lead, then the subclass's masked decoder block."""
        lp = self._post_fn(ctx)                             # [N, cap, D]
        idx = torch.clamp(
            skip[:, None] + torch.arange(cap, device=ctx.device)[None, :],
            0, cap - 1).long()
        lp = torch.gather(lp, 1, idx[:, :, None].expand(-1, -1,
                                                         lp.shape[2]))
        self._mark("posteriors")
        return self._decode_block(carry, lp, n_dec.to(torch.int32),
                                  n_valid.to(torch.int32))

    def _fused_impl(self, span, v, mel_tail, primed, carry, n_mel, n_dec,
                    onst):
        """One multi-stream block: span [N, samples] with v[b] valid new
        frames in row b (v, n_mel, n_dec int32 device tensors)."""
        with profiling.span("serve.launch"):
            s = self.trap_shift
            ts2 = 2 * s
            par = self._front(span)                     # [N, block, nb]
            par, onst = self._onorm(par, v, n_mel, onst)
            tail_eff = torch.where(primed[:, None, None], mel_tail,
                                   par[:, :1].expand(-1, ts2, -1))
            ctx = torch.cat([tail_eff, par], dim=1)
            tidx = (v[:, None]
                    + torch.arange(ts2, device=v.device)[None, :])
            new_tail = torch.gather(ctx, 1, tidx.long()[:, :, None].expand(
                -1, -1, ctx.shape[2]))
            skip = torch.minimum(torch.clamp(s - n_mel, min=0), v)
            carry, hist = self._decode_ctx(ctx, skip, carry, n_dec,
                                           v - skip, self.block)
            return new_tail, primed | (v > 0), carry, hist, onst

    def _fused_flush(self, mel_tail, carry, n_mel, n_dec):
        """ProcessTail per stream (srec.cpp:877-927): repeat each row's
        last mel frame trap_shift times; rows with n_mel < s valid frames
        flush only n_mel rows."""
        s = self.trap_shift
        reps = mel_tail[:, -1:].expand(-1, s, -1)
        ctx = torch.cat([mel_tail, reps], dim=1)             # [N, 3s, nb]
        skip = torch.clamp(s - n_mel, 0, s)
        return self._decode_ctx(ctx, skip, carry, n_dec, s - skip, s)

    def _i32(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int32), device=self.device)

    def _mine(self, b: int) -> bool:
        return self._rows.start <= b < self._rows.stop

    def _gather(self, rows: List) -> List:
        """Every stream's entry of a per-row list (this rank's rows):
        all-gathered over the mesh, the list itself without one."""
        if self._axis is None:
            return rows
        from phnrec_tpu_torch.parallel.mesh import all_gather_object
        return [r for part in all_gather_object(rows, self._axis)
                for r in part]

    def shard_audio(self, audio) -> torch.Tensor:
        """This rank's rows of an [N, L] sample buffer (a tensor or an
        array), on its card: the buffer decode_device_buffer and
        dispatch_from_device_buffer read (all N rows without a mesh)."""
        return torch.as_tensor(audio[self._rows]).to(self.device)

    # -- feeding ---------------------------------------------------------
    def process(self, i: int, raw: bytes) -> None:
        """Push raw audio bytes for stream ``i``.  With a mesh, a stream of
        another rank only advances its pending sample count."""
        if self._ended[i]:
            raise ValueError(f"stream {i} already ended")
        sr = self.sr
        if sr.wave_format == "lin16":
            raw = self._byte_rem[i] + raw
            cut = len(raw) - (len(raw) % 2)
            raw, self._byte_rem[i] = raw[:cut], raw[cut:]
            n = cut // 2
            if self._mine(i):
                wave = (np.frombuffer(raw, dtype="<i2") if self._i16
                        else _convert_chunk(raw, sr))
        else:
            n = len(raw)
            if self._mine(i):
                wave = _convert_chunk(raw, sr)
        if self._mine(i):
            self._bufs[i] = np.concatenate([self._bufs[i], wave])
        self._buf_len[i] += n
        if self.auto_pump:
            self.pump()

    def end_stream(self, i: int) -> None:
        """Mark stream ``i`` finished (no more audio will arrive); its
        leftovers drain on subsequent pumps/finish."""
        self._ended[i] = True

    def _pending(self) -> np.ndarray:
        lens = self._buf_len
        return np.where(lens >= self.vs,
                        (lens - self.vs) // self.step_len + 1, 0)

    def _round_span(self):
        """The span ``serve.round`` of the next round."""
        self._round += 1
        return profiling.span("serve.round",
                              id=(self._server, self._round - 1))

    def _dispatch(self, v: np.ndarray) -> None:
        """One fused block consuming v[b] frames from stream b."""
        need = (self.block - 1) * self.step_len + self.vs
        span = np.zeros((self._nl, need), self._bufs[0].dtype)
        for j, b in enumerate(range(self._rows.start, self._rows.stop)):
            if v[b] > 0:
                take = (int(v[b]) - 1) * self.step_len + self.vs
                span[j, :take] = self._bufs[b][:take]
                self._bufs[b] = self._bufs[b][int(v[b]) * self.step_len:]
        self._buf_len -= v.astype(np.int64) * self.step_len
        r = self._rows
        with self._round_span():
            self._record(v, self._fused_impl(
                torch.from_numpy(span).to(self.device), self._i32(v[r]),
                self._mel_tail, self._primed, self._carry,
                self._i32(self._n_mel[r]), self._i32(self._n_dec[r]),
                self._onorm_state))

    def pump(self) -> int:
        """Dispatch fused blocks per the pump policy: lockstep (every live
        stream must fill a block; ended streams contribute what they have)
        or partial (any live stream with a full block triggers a dispatch
        and the rest contribute what they have).  Returns the number of
        blocks dispatched."""
        n_blocks = 0
        while True:
            pending = self._pending()
            if self._ended.all():
                go = pending.max(initial=0) >= 1
            elif self.partial_pump:
                go = bool((pending[~self._ended] >= self.block).any())
            else:
                ready = np.where(self._ended, pending > 0,
                                 pending >= self.block)
                go = bool(np.all(ready | self._ended)
                          and pending.max(initial=0) >= self.block)
            if not go:
                return n_blocks
            self._dispatch(np.minimum(pending, self.block))
            n_blocks += 1

    def _record(self, v: np.ndarray, out) -> None:
        """Book-keep one fused dispatch's outputs."""
        new_tail, primed, carry, hist, self._onorm_state = out
        skip = np.clip(self.trap_shift - self._n_mel, 0, v)
        self._mel_tail, self._primed, self._carry = new_tail, primed, carry
        valid = (v - skip).astype(np.int64)
        self._append_hist(hist, valid)
        self._n_mel += v
        self._n_dec += valid
        self._primed_host |= v > 0
        self._maybe_commit()

    # -- fixed-lag commit (commit_horizon) --------------------------------
    def _append_hist(self, out, valid: np.ndarray) -> None:
        """Retain one block output with every stream's valid rows [N] (this
        rank's rows kept beside it)."""
        self._hist.append((out, valid[self._rows]))
        if self._axis is not None and self._commits():
            self._g_valid.append(valid)

    def _commits(self) -> bool:
        """Whether this server commits (and drops) History blocks."""
        return self.commit_horizon is not None

    def _retained(self) -> int:
        """The most History rows any stream retains, as the unsharded
        server counts them (the commit trigger)."""
        off = self._row_offset if self._axis is None else \
            self._g_row_offset
        return int((self._n_dec - off).max(initial=0))

    def _drop_committed_blocks(self) -> None:
        """Drop leading history blocks once EVERY stream's rows in them are
        committed (block 0 spans [row_offset_b, row_offset_b + v0_b));
        with a mesh, this rank's streams, and then the blocks every rank
        has dropped leave the trigger's count."""
        while self._hist:
            _, v0 = self._hist[0]
            if np.all(self._row_offset + v0 <= self._frame0):
                self._row_offset += v0.astype(np.int64)
                self._hist.pop(0)
                self._n_dropped += 1
            else:
                break
        if self._axis is not None:
            import torch.distributed as dist

            from phnrec_tpu_torch.parallel.mesh import all_reduce
            every = int(all_reduce([self._n_dropped], self._axis,
                                   dist.ReduceOp.MIN)[0])
            while len(self._g_valid) > len(self._hist) + self._n_dropped \
                    - every:
                self._g_row_offset += self._g_valid.pop(0)

    def _hist_to_host(self) -> None:
        """Bring the retained device History blocks to the host as numpy
        arrays (the ragged and host-commit paths read them there)."""
        for i, (h, v) in enumerate(self._hist):
            if isinstance(h[0], torch.Tensor):
                self._hist[i] = (phnloop.History(
                    *(a.cpu().numpy() for a in h)), v)

    def _stream_hist(self, b: int) -> Optional[phnloop.History]:
        """Stream b's valid rows of the host-resident blocks, in order."""
        cols = [tuple(a[: int(v[b]), b] for a in h)
                for h, v in self._hist if v[b] > 0]
        if not cols:
            return None
        return phnloop.History(
            *(np.concatenate([c[j] for c in cols]) for j in range(3)))

    def _hist_device_uniform(self):
        """The per-block valid counts when every retained block is on the
        device and stream-uniform (the lockstep serving steady state),
        else None."""
        if not self._hist or not isinstance(self._hist[0][0][0],
                                            torch.Tensor):
            return None
        valids = np.stack([v for _, v in self._hist])
        if not (valids == valids[:, :1]).all():
            return None
        return tuple(int(v[0]) for _, v in self._hist)

    def _window(self, key) -> phnloop.History:
        """The retained device blocks' valid rows, concatenated."""
        return phnloop.History(*(
            torch.cat([h[j][:k] for (h, _), k in zip(self._hist, key)])
            for j in range(3)))

    def _walk_window_device(self, key):
        """The committed-window walk on the device (kernel D') over the
        retained blocks (T > 0 rows): its segments on the host (starts
        window-relative), the streams' frame counts, and each stream's
        rebased path like at its horizon end (for forced splits).  Only
        the compact segments and one [N] row cross to the host; the
        History stays on the device."""
        T = sum(key)
        hist = self._window(key)
        n_dec = self._n_dec[self._rows]
        n_rel = n_dec - self._row_offset
        h_end_rel = np.clip(n_dec - (self.commit_horizon or 0) - 1
                            - self._row_offset, 0, T - 1)
        segs = phnloop.backtrack_device_committed(
            self.sr.loop_spec, hist, self._i32(n_rel),
            self._i32(self._frame0), self._i32(self._row_offset))
        self._mark("backtrack")
        a_h = hist.alpha.gather(0, self._i32(h_end_rel).long()[None])[0]
        segs = phnloop.fetch_segments(segs, cap=min(4096, segs.phn.shape[1]))
        return segs, n_dec, a_h.cpu().numpy()

    def _rebase_alphas(self) -> None:
        """Subtract each stream's committed like (_alpha0) from its
        retained scores and from its carried alphas, on whichever side
        each block lives, sparing the NEG_INF sentinels (a shift would
        overflow them to -inf): the recurrence is shift-invariant, and
        |alpha| stays bounded by the window's like over long sessions,
        where session-cumulative float32 scores would quantise below
        log(0.5).  (phnrec_tpu's _rebase_device is the same on its
        device blocks.)"""
        r32 = self._alpha0.astype(np.float32)
        if not r32.any():
            return
        rt = torch.from_numpy(r32).to(self.device)
        alphas, ent = self._carry
        self._carry = (torch.where(
            alphas <= float(phnloop.NEG_INF / 2), alphas,
            alphas - rt[None, None, :]), ent)
        self._hist = [
            (phnloop.History(h.max_phn, h.ent, h.alpha - (
                r32[None, :] if isinstance(h.alpha, np.ndarray)
                else rt[None, :])), v)
            for h, v in self._hist]
        self._alpha0[:] = 0.0

    def _commit_device(self, key) -> None:
        """The commit with the walk and the rebase on the device: per
        cycle one launch of kernel D' and a fetch of ~7 bytes a segment,
        whatever the stream count.  The walk's labels stay arrays
        (columns_from_segments) and every stream commits in one pass
        (commit_columns); the committed ones are kept as arrays and made
        into Labels once, when results() asks."""
        segs, n_dec, a_h = self._walk_window_device(key)
        cols = phnloop.columns_from_segments(segs, n_dec,
                                             row_offset=self._row_offset)
        with profiling.span("serve.commit_streams"):
            # a_h[b] is the rebased path like at horizon_end - 1
            commit, frame0, alpha0 = phnloop.commit_columns(
                cols, n_dec - self.commit_horizon, a_h)
            done = commit.count > 0
            self._frame0[done] = frame0[done]
            self._alpha0[done] = alpha0[done]
            self._keep(commit)
        self._drop_and_rebase()

    def _keep(self, commit: phnloop.Columns) -> None:
        """Keep one commit's labels (flat Columns) as arrays."""
        n = int(commit.count.sum())
        if n:
            self._kept.append(commit)
            profiling.count("labels.kept", n)

    def _committed_labels(self) -> List[List[Label]]:
        """Each stream's committed labels: the blocks kept since the last
        call made into Labels, each label once, in one pass (span
        ``labels.build``, counter ``labels.built``) and appended to the
        ones made before.  The pass runs with the collector paused: its
        Labels of atoms and the lists holding them form no cycle, so a
        collection could free nothing and would only walk the session's
        labels again."""
        if not self._kept:
            return self._made
        kept, self._kept = self._kept, []
        names = np.asarray(self.sr.phonemes, dtype=object)
        with profiling.span("labels.build") as traced, collector.paused():
            for n, start, end, phn, like in kept:
                made = list(map(Label, start.tolist(), end.tolist(),
                                names[phn].tolist(), like.tolist()))
                if traced is not None:
                    profiling.count("labels.built", len(made))
                o = 0
                for b, k in enumerate(n.tolist()):
                    if k:
                        self._made[b] += made[o: o + k]
                        o += k
        return self._made

    def _wait_card(self) -> None:
        """Wait for the rounds queued on the card, the span ``fetch.wait``:
        the commit's first copy of a pageable array to the card would wait
        for them anyway."""
        with profiling.span("fetch.wait"):
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()

    def _drop_and_rebase(self) -> None:
        """Drop the committed History blocks and rebase the scores."""
        with profiling.span("serve.rebase"):
            self._drop_committed_blocks()
            self._rebase_alphas()

    def _commit_stream(self, b: int, labels: List[Label],
                       like_at_horizon) -> List[Label]:
        """commit_labels on stream b's window walk: its committed labels,
        with the boundary moved past them."""
        got = phnloop.commit_labels(
            labels, int(self._n_dec[self._lo + b]) - self.commit_horizon,
            like_at_horizon)
        if got is None:
            return []
        commit, self._frame0[b], self._alpha0[b] = got
        return commit

    def _maybe_commit(self) -> None:
        if self.commit_horizon is None or not self._hist:
            return
        if self._retained() <= 2 * self.commit_horizon + self.block:
            return
        profiling.count("serve.commits")
        with profiling.span("serve.commit"):
            self._wait_card()
            key = self._hist_device_uniform()
            if key is not None:
                self._commit_device(key)
                return
            # streams advanced unevenly: replay each on the host
            self._hist_to_host()
            with profiling.span("serve.commit_streams"):
                commits = []
                for b in range(self._nl):
                    hist_b = self._stream_hist(b)
                    if hist_b is None:
                        commits.append([])
                        continue
                    labels = phnloop.backtrack_committed(
                        hist_b, int(self._row_offset[b]),
                        int(self._frame0[b]), float(self._alpha0[b]),
                        self.sr.phonemes)
                    h_row = int(self._n_dec[self._lo + b]) \
                        - self.commit_horizon - 1 \
                        - int(self._row_offset[b])
                    commits.append(self._commit_stream(
                        b, labels, lambda: float(hist_b.alpha[h_row])
                        - float(self._alpha0[b])))
                ids = {p: i for i, p in enumerate(self.sr.phonemes)}
                flat = [l for c in commits for l in c]
                self._keep(phnloop.Columns(
                    np.array([len(c) for c in commits], np.int64),
                    np.array([l.start_frames for l in flat], np.int64),
                    np.array([l.end_frames for l in flat], np.int64),
                    np.array([ids[l.name] for l in flat], np.int8),
                    np.array([l.score for l in flat], np.float64)))
            self._drop_and_rebase()

    # -- device-resident feeding (serving and benchmark path); with a mesh
    # each buffer holds this rank's rows (shard_audio) ----------------------
    def dispatch_block_device(self, span_dev: torch.Tensor) -> None:
        """Advance every stream by exactly ``block`` frames from a sample
        span [N, (block - 1) * step + vs] already on the device (network
        DMA in production, staged audio in benchmarks)."""
        v = np.full(self.n, self.block, np.int64)
        r = self._rows
        with self._round_span():
            self._record(v, self._fused_impl(
                span_dev, self._i32(v[r]), self._mel_tail,
                self._primed, self._carry, self._i32(self._n_mel[r]),
                self._i32(self._n_dec[r]), self._onorm_state))

    def dispatch_from_device_buffer(self, audio_dev: torch.Tensor,
                                    sample_offset: int) -> None:
        """Advance every stream by ``block`` frames reading samples
        [sample_offset, sample_offset + span) of a device-resident [N, L]
        buffer."""
        need = (self.block - 1) * self.step_len + self.vs
        if audio_dev.dim() != 2 or audio_dev.shape[0] != self._nl or \
                sample_offset < 0 or \
                sample_offset + need > audio_dev.shape[1]:
            raise ValueError(f"audio buffer of shape "
                             f"{tuple(audio_dev.shape)} does not hold "
                             f"samples {sample_offset}..{sample_offset + need}"
                             f" of {self._nl} streams")
        self.dispatch_block_device(
            audio_dev[:, sample_offset: sample_offset + need])

    def decode_device_buffer(self, audio_dev: torch.Tensor, n_blocks: int,
                             first_block: int = 0) -> None:
        """Advance every stream by ``n_blocks`` * block frames from a
        device-resident [N, L] sample buffer: one fused block per block
        offset, all bookkeeping carried on the device, one merged block
        output for the whole run."""
        # the merged output removes ONE delay-gate gap, at the end of the
        # first block; a stream whose remaining skip (trap_shift - n_mel)
        # exceeds block_frames would spill skip into the next block
        if np.any(self.trap_shift - self._n_mel > self.block):
            raise ValueError(
                "decode_device_buffer needs block_frames >= each "
                "stream's remaining delay-gate skip (trap_shift - "
                "frames_seen); feed more audio via process() first or "
                "use a larger block")
        if n_blocks <= 0:
            return
        need = (self.block - 1) * self.step_len + self.vs
        spb = self.block * self.step_len
        end = (first_block + n_blocks - 1) * spb + need
        if audio_dev.dim() != 2 or audio_dev.shape[0] != self._nl or \
                end > audio_dev.shape[1]:
            raise ValueError(f"audio buffer of shape "
                             f"{tuple(audio_dev.shape)} does not hold "
                             f"blocks {first_block}..{first_block + n_blocks}"
                             f" of {self._nl} streams ({end} samples)")
        s = self.trap_shift
        vb = torch.full((self._nl,), self.block, dtype=torch.int32,
                        device=self.device)
        n_mel = self._i32(self._n_mel[self._rows])
        n_dec = self._i32(self._n_dec[self._rows])
        st = (self._mel_tail, self._primed, self._carry, self._onorm_state)
        hists = []
        for k in range(first_block, first_block + n_blocks):
            mel_tail, primed, carry, onst = st
            span = audio_dev[:, k * spb: k * spb + need]
            skip = torch.clamp(s - n_mel, 0, self.block)
            new_tail, primed, carry, hist, onst = self._fused_impl(
                span, vb, mel_tail, primed, carry, n_mel, n_dec, onst)
            st = (new_tail, primed, carry, onst)
            n_mel = n_mel + vb
            n_dec = n_dec + vb - skip
            hists.append(hist)
        self._mel_tail, self._primed, self._carry, self._onorm_state = st
        skip0 = np.clip(self.trap_shift - self._n_mel, 0, self.block)
        valid = (np.int64(n_blocks) * self.block - skip0).astype(np.int64)
        self._append_hist(self._compact_scan(hists, skip0[self._rows],
                                             n_blocks, self._nl), valid)
        self._n_mel += n_blocks * self.block
        self._n_dec += valid
        self._primed_host[:] = True
        self._maybe_commit()

    # -- results ---------------------------------------------------------
    def finish(self) -> List[List[Label]]:
        """Drain leftovers, flush the STC tail, return every stream's
        results() (with commit_horizon, the committed labels not yet made
        into Labels are made here, in one pass)."""
        with profiling.span("serve.finish", id=(self._server, self._round)):
            return self._finish()

    def _finish(self) -> List[List[Label]]:
        if not self._flushed:
            self._ended[:] = True
            # pump() with every stream ended drains ALL pending frames
            # (ragged final blocks included)
            while self.pump():
                pass
            if self._primed_host.any():
                r = self._rows
                carry, hist = self._fused_flush(
                    self._mel_tail, self._carry, self._i32(self._n_mel[r]),
                    self._i32(self._n_dec[r]))
                self._carry = carry
                valid = np.where(self._primed_host,
                                 np.minimum(self.trap_shift, self._n_mel),
                                 0).astype(np.int64)
                self._append_hist(hist, valid)
                self._n_dec += valid
            self._flushed = True
            self.save_norm_params()
        return self.results()

    def save_norm_params(self) -> None:
        """Persist each stream's frozen online-norm estimate to the
        config's onlinenorm/file, channel id = stream index — the
        multi-stream form of the reference's per-channel XML save
        (norm.cpp:230,309-364).  With a mesh the ranks' estimates are
        gathered and the data group's rank 0 writes the file."""
        on = self.online_norm
        if (not on.enabled or self._on_E == 0 or on.file in ("", "none")
                or not self._onorm_state):
            return
        cnt, sx, sxx = (t.cpu().numpy() for t in self._onorm_state)
        # start from channels already known to the host estimator so a
        # re-save never drops them (norm.cpp:309 saves the full map)
        chans = {cid: (st["mean"], st["inv_std"])
                 for cid, st in on.channels.items()}
        E = np.float32(self._on_E)
        new = {}
        for b in range(self._nl):
            if int(cnt[b]) >= self._on_E:
                mean = (sx[b] / E).astype(np.float32)
                var = np.maximum(sxx[b] / E - mean * mean,
                                 np.float32(1e-20))
                new[self._lo + b] = (mean,
                                     (1.0 / np.sqrt(var)).astype(np.float32))
        parts = self._gather([new])
        for part in parts:
            chans.update(part)
        if any(parts) and (self._axis is None or self._axis.rank == 0):
            save_norm_file(on.file, chans)

    def results(self) -> List[List[Label]]:
        """Every stream's labels so far: the backtrack of its history
        (stitched onto the committed prefix with commit_horizon).  The
        commits keep their labels as arrays; the labels committed since
        the last call are made into Labels here, each once, so a server
        that polls makes them as it goes and one that reads at finish()
        makes them in one pass."""
        return self._gather(self._local_results())

    def _local_results(self) -> List[List[Label]]:
        phonemes = self.sr.phonemes
        nl = self._nl
        n_dec = self._n_dec[self._rows]
        if self.commit_horizon is not None:
            key = self._hist_device_uniform()
            if key is not None:
                window = [[] for _ in range(nl)]
                if sum(key):
                    segs, n_dec, _ = self._walk_window_device(key)
                    window = phnloop.labels_from_segments(
                        segs, n_dec, phonemes, row_offset=self._row_offset)
                made = self._committed_labels()
                return [made[b] + window[b] for b in range(nl)]
            self._hist_to_host()
            made = self._committed_labels()
            out: List[List[Label]] = []
            for b in range(nl):
                hist_b = self._stream_hist(b)
                tail = [] if hist_b is None else \
                    phnloop.backtrack_committed(
                        hist_b, int(self._row_offset[b]),
                        int(self._frame0[b]), float(self._alpha0[b]),
                        phonemes)
                out.append(made[b] + tail)
            return out
        if not self._hist:
            return [[] for _ in range(nl)]
        valids = np.stack([v for _, v in self._hist])      # [K, N]
        if (valids == valids[:, :1]).all():
            # lockstep: every row has the same per-block validity, so the
            # window is a device concatenation and the walk runs there
            # (kernel D); only ~7 bytes a segment cross to the host
            key = tuple(int(v[0]) for _, v in self._hist)
            T = sum(key)
            if T == 0:
                return [[] for _ in range(nl)]
            self._hist = [(phnloop.History(
                *(torch.as_tensor(a, device=self.device) for a in h)), v)
                for h, v in self._hist]
            hist = self._window(key)
            if T >= 1 << 20:
                return phnloop.backtrack_batch(hist, n_dec, phonemes)
            segs = phnloop.backtrack_device(self.sr.loop_spec, hist,
                                            self._i32(n_dec))
            self._mark("backtrack")
            segs = phnloop.fetch_segments(
                segs, cap=min(4096, segs.phn.shape[1]))
            self._mark("fetch")
            return phnloop.labels_from_segments(segs, n_dec, phonemes)
        # ragged: fetch once, replay each stream on the host
        self._hist_to_host()
        return [[] if (h := self._stream_hist(b)) is None else
                phnloop.backtrack(h, phonemes) for b in range(nl)]


class MultiStreamKWS(MultiStreamRecognizer):
    """N concurrent LIVE KEYWORD-SPOTTING streams on one device: the
    stkint KWS chain — posterior stack, the network Viterbi block and the
    LRTrace candidate scan (kernel F, ops/lrtrace.py) — batched over
    streams inside the fused blocks.

    The per-stream carry is (network state [N, ...], LRTrace state [N, K],
    beam [N], the global <InputXform>'s delay lines [N, ...] or ()); flush
    events go into per-stream hit rings on the device and are decoded on
    the host at results()/hits_so_far().

    The network block is the dense step, kernel B (ops/netstep.py), where
    the network has at most 1024 models + states and the uniform
    left-to-right structure every generated KWS network has
    (``extract_structure``, the JAX package's gate); any other network —
    bigger, or irregular — runs the edge-list scan, kernel G
    (ops/netscan.py), one launch a block, whose sink records feed F.
    ``net_path`` records which ("kernel_b" or "kernel_g"); on CPU tensors
    each runs its plain version.  (JAX runs an irregular small network
    through its XLA dense step, whose records equal the edge-list scan's
    by the tie-parity invariant DenseKWSScan asserts.)"""

    def __init__(self, sr, n_streams: int, block_frames: int = 128,
                 auto_pump: bool = True, mesh=None,
                 partial_pump: bool = False):
        dec = sr.stk_decoder
        if dec is None or dec.mode != "kws":
            raise ValueError("MultiStreamKWS needs an stkint package "
                             "with decoder/mode=kws")
        self._xform_inst = dec.model_set.input_xform
        self._dec = dec
        self._keywords = dec.keywords()
        c = dec.compiled
        if c.kws_filler_sink is None or not c.kws_word_sinks:
            raise ValueError(
                "KWS network needs a filler-end sink and at least one "
                "sticky keyword-end node (stkinterface.cpp:107-155 node "
                "discovery found none in this network)")
        self._kws_ws = torch.tensor(np.asarray(c.kws_word_sinks, np.int32),
                                    device=sr.device)
        self._kws_fs = c.kws_filler_sink
        self._beam0 = float(OFF_BEAM if dec.beam_pruning is None
                            else dec.beam_pruning)
        self._tp = dec.time_pruning
        self._sp = dec.kws_score_pruning
        self._dense = self._net_block = None
        if c.n_models + c.n_states <= DENSE_MAX:
            self._dense = DenseKWSScan(dec.decoder)
            self._net_block = netstep.build_net_block_fn(self._dense)
        self.net_path = ("kernel_b" if self._net_block is not None
                         else "kernel_g")
        self._hits_emitted = [0] * n_streams
        # per-stream Label lists (this rank's streams), built
        # incrementally as event blocks are fetched (decoded device blocks
        # are dropped); sized once the base class has placed the rows
        self._labels: List[List[Label]] = []
        self._final_done = False
        super().__init__(sr, n_streams, block_frames=block_frames,
                         auto_pump=auto_pump, mesh=mesh,
                         partial_pump=partial_pump)
        self._labels = [[] for _ in range(self._nl)]

    def set_beam_pruning(self, v: Optional[float]) -> None:
        """Live beam-pruning knob (SetBeamPruning, stkinterface.h:108):
        the width rides in the decode carry, so it affects the next
        block."""
        beam = torch.full((self._nl,), float(OFF_BEAM if v is None else v),
                          device=self.device)
        self._carry = self._carry[:2] + (beam, self._carry[3])

    # -- decoder hooks ---------------------------------------------------
    def _check_decoder(self, sr) -> None:
        pass                                   # validated in __init__

    def _init_decode_carry(self):
        nl = self._nl
        stk = (self._dense.init_carry(nl, self.device)
               if self._net_block is not None else
               self._dec.decoder.init_carry(self.device, nl))
        trk = lrtrace_init_state(len(self._keywords), nl, self.device)
        return (stk, trk, torch.full((nl,), self._beam0, device=self.device),
                self._xform_state0())

    def _decode_block(self, carry, lp, n_dec, n_valid):
        stk_c, trk, beam, xst = carry
        xst, lp = self._apply_xform(xst, lp, n_valid)
        dec = self._dec.decoder
        if self._net_block is not None:
            # [N, F, D] -> [F, N, E]: frame-major, as kernel B reads it
            obs_fm = dec.state_observations(lp.transpose(0, 1)).contiguous()
            stk_c, (sv, sw) = self._net_block(stk_c, obs_fm, n_valid, n_dec,
                                              beam)
            self._mark("netstep")
        else:
            # the edge-list scan's valid bound is absolute
            stk_c, recs = dec.scan_block(stk_c, dec.state_observations(lp),
                                         n_dec, n_dec + n_valid, beam)
            sv = recs["sink_val"].transpose(0, 1).contiguous()
            sw = recs["sink_wt"].transpose(0, 1).contiguous()
            self._mark("netscan")
        trk, events = lrtrace.lrtrace_scan(
            trk, sv, sw, self._kws_ws, self._kws_fs, n_dec, n_valid,
            self._tp, self._sp)
        self._mark("lrtrace")
        rings = self._compact_events(events)
        self._mark("compact")
        return (stk_c, trk, beam, xst), rings

    def _compact_events(self, events):
        """Scatter the block's flush events into a small per-stream ring
        of H slots (+1 dump slot) on the device: rows fill in flat (frame,
        slot, keyword) order — the reference callback order — so the ring
        IS the emission sequence.  A stream whose count exceeds H falls
        back to the dense records, which are kept alongside."""
        rec1, rec2 = events
        N, F = rec1["emit"].shape[:2]
        Kw = len(self._keywords)
        H = max(64, F // 4)
        L = F * 2 * Kw

        def stk(name):
            return torch.stack([rec1[name], rec2[name]], dim=2)

        em = stk("emit")                       # [N, F, 2, Kw]
        flat = em.reshape(N, L)
        pos = torch.cumsum(flat, dim=1, dtype=torch.int32) - 1
        idx = torch.where(flat & (pos < H), pos, H).long()

        def ring_of(vals, dt):
            z = torch.zeros((N, H + 1), dtype=dt, device=flat.device)
            return z.scatter_(1, idx, vals.reshape(N, L).to(dt))

        dev = flat.device
        slot_i = torch.arange(2, dtype=torch.int32,
                              device=dev)[None, None, :, None]
        k_i = torch.arange(Kw, dtype=torch.int32,
                           device=dev)[None, None, None, :]
        kid = (slot_i * Kw + k_i) * 2 + stk("new_estim").to(torch.int32)
        return {
            "count": torch.sum(flat, dim=1, dtype=torch.int32),
            "start": ring_of(stk("start"), torch.int32),
            "end": ring_of(stk("end"), torch.int32),
            "score": ring_of(stk("score"), torch.float32),
            "kid": ring_of(kid, torch.int32),
            "dense": (rec1, rec2),
        }

    def _compact_scan(self, hists, skip0, K: int, N: int):
        # per-block rings keep their block axis (each sub-ring has its own
        # count); the dense fallback records merge on the frame axis (dead
        # frames emit nothing, so no gather)
        out = {k: torch.stack([h[k] for h in hists], dim=1)
               for k in ("count", "start", "end", "score", "kid")}
        out["dense"] = tuple(
            {k: torch.cat([h["dense"][r][k] for h in hists], dim=1)
             for k in hists[0]["dense"][r]} for r in range(2))
        return out

    # -- results ---------------------------------------------------------
    def _fetch_rings(self):
        """Every pending block's rings and counts in ONE device->host copy
        (float scores travel bit-cast as int32)."""
        keys = ("count", "start", "end", "score", "kid")
        parts, shapes = [], []
        for h, _ in self._hist:
            for k in keys:
                t = h[k]
                shapes.append(tuple(t.shape))
                if t.dtype == torch.float32:
                    t = t.view(torch.int32)
                parts.append(t.reshape(-1))
        flat = torch.cat(parts).cpu().numpy()
        out, off, j = [], 0, 0
        for _ in self._hist:
            comp = {}
            for k in keys:
                size = int(np.prod(shapes[j]))
                a = flat[off: off + size].reshape(shapes[j])
                comp[k] = a.view(np.float32) if k == "score" else a
                off += size
                j += 1
            out.append(comp)
        return out

    def _sync(self) -> None:
        """Fetch + decode the pending event blocks into the per-stream
        Label lists, then DROP them (decoded blocks are never re-read),
        and append the final candidate flush once after finish().  Only
        the compact hit rings are fetched; a stream whose ring overflowed
        (count > H) decodes that block from its dense records.  Traced
        (utils/profiling.py) where there is something to fetch or flush:
        span ``kws.sync`` around ``kws.fetch`` (the device-to-host copies
        and their wait) and ``kws.decode`` (the rings and the dense
        fallback into Labels), counters ``kws.syncs``, ``kws.hits`` (the
        Labels decoded) and ``kws.overflow_streams`` (the streams'
        dispatches decoded from the dense records)."""
        final = self._flushed and not self._final_done
        if not self._hist and not final:
            return
        with profiling.span("kws.sync"):
            profiling.count("kws.syncs")
            made = sum(map(len, self._labels))
            if self._hist:
                self._decode_pending()
            if final:
                self._flush_final()
            profiling.count("kws.hits", sum(map(len, self._labels)) - made)

    def _decode_pending(self) -> None:
        with profiling.span("kws.fetch"):
            fetched = self._fetch_rings()
        with profiling.span("kws.decode"):
            denses = [h["dense"] for h, _ in self._hist]
            self._hist = []
            Kw = len(self._keywords)
            for comp, dense in zip(fetched, denses):
                cnt = comp["count"]
                multi = cnt.ndim == 2      # merged blocks: [N, Kb]
                if not multi:
                    cnt = cnt[:, None]
                rings = {k: comp[k] for k in ("start", "end", "score",
                                              "kid")}
                if not multi:
                    rings = {k: v[:, None] for k, v in rings.items()}
                H = rings["start"].shape[2] - 1
                ok_b = ~(cnt > H).any(axis=1)
                mask = ((np.arange(H)[None, None, :]
                         < np.minimum(cnt, H)[:, :, None])
                        & ok_b[:, None, None])
                bb, jj, rr = np.nonzero(mask)
                starts = rings["start"][bb, jj, rr].tolist()
                ends = rings["end"][bb, jj, rr].tolist()
                scores = rings["score"][bb, jj, rr].astype(
                    np.float64).tolist()
                kids = rings["kid"][bb, jj, rr].tolist()
                names = [self._keywords[(k >> 1) % Kw] for k in kids]
                bounds = np.searchsorted(bb, np.arange(self._nl + 1))
                for b in range(self._nl):
                    lo, hi = bounds[b], bounds[b + 1]
                    if lo != hi:
                        self._labels[b].extend(map(
                            Label, starts[lo:hi], ends[lo:hi],
                            names[lo:hi], scores[lo:hi]))
                over = np.nonzero(~ok_b)[0]
                profiling.count("kws.overflow_streams", len(over))
                for b in over:
                    # some sub-ring overflowed (with score pruning off,
                    # every stream's of a 40-keyword network does) ->
                    # decode this stream's whole dispatch from the dense
                    # records
                    sub = tuple({k2: v[b].cpu().numpy()
                                 for k2, v in rec.items()}
                                for rec in dense)
                    self._labels[b].extend(
                        Label(h.start, h.end, h.word, h.score)
                        for h in decode_lrtrace_events(
                            sub, self._keywords))

    def _flush_final(self) -> None:
        """StkInterface::Done: flush outstanding candidates from the
        final tracker state, per stream in keyword order."""
        self._final_done = True
        with profiling.span("kws.fetch"):
            trk = [t.cpu().numpy() for t in self._carry[1]]
        with profiling.span("kws.decode"):
            sp = float(self._sp)
            for b in range(self._nl):
                row = tuple(leaf[b] for leaf in trk)
                self._labels[b].extend(
                    Label(h.start, h.end, h.word, h.score)
                    for h in flush_outstanding_candidates(
                        row, self._keywords, sp))

    def results(self) -> List[List[Label]]:
        """Per-stream KWS hits flushed so far (live callback stream); at
        finish() the outstanding candidates are force-flushed too."""
        self._sync()
        return self._gather([list(lb) for lb in self._labels])

    def hits_so_far(self, i: int) -> List[Label]:
        """Newly flushed hits for stream ``i`` since the last call — the
        per-stream live callback (DECMSG_WORD emission).  With a mesh it
        serves this rank's streams."""
        if not self._mine(i):
            raise ValueError(f"stream {i} is served by another rank")
        self._sync()
        labels = self._labels[i - self._lo]
        new = labels[self._hits_emitted[i]:]
        self._hits_emitted[i] = len(labels)
        return list(new)


class MultiStreamStkDecode(MultiStreamRecognizer):
    """N concurrent stkint DECODE-mode streams on one device: the live
    word-network serving mode (StkInterface::ProcessFrame's decode branch
    with fixed-lag word emission, stkinterface.cpp:214-238) batched over
    streams inside the fused blocks.  Counterpart of
    phnrec_tpu/multistream.py:1244-1596.

    The per-stream carry is (network state [N, ...], beam [N], the global
    <InputXform>'s delay lines [N, ...] or ()).  Each block's network step
    emits per-frame traceback records [N, F, .] that stay on the device,
    ids as int16 where every id table fits: kernel E (ops/netdecode.py)
    for networks of at most 1024 models + states with the uniform
    left-to-right structure, kernel G (ops/netscan.py) for any other —
    ``net_path`` says which.  The fixed-lag commit
    walks the retained window on the device (kernel H with the
    committed-boundary stop) when every retained block is stream-uniform,
    on the host (``traceback_host``) otherwise: labels ending at least
    time_pruning frames behind a stream's newest frame move to its
    committed list (the reference's TimePruning ring, Viterbi.cc:65-125),
    blocks every stream has committed are dropped, and committed likes are
    rebased out of the retained values and the carry, so memory is
    O(N * horizon) over unbounded sessions."""

    def __init__(self, sr, n_streams: int, block_frames: int = 128,
                 auto_pump: bool = True, mesh=None,
                 record_horizon: Optional[int] = None,
                 partial_pump: bool = False):
        """``record_horizon``: the retained record rows (frames) a stream
        may pass before a commit is tried; default max(4 * time_pruning,
        4 * block_frames, 512)."""
        dec = sr.stk_decoder
        if dec is None or dec.mode != "decode":
            raise ValueError("MultiStreamStkDecode needs an stkint "
                             "package with decoder/mode=decode")
        self._dec = dec
        self._beam0 = float(OFF_BEAM if dec.beam_pruning is None
                            else dec.beam_pruning)
        self._xform_inst = dec.model_set.input_xform
        c = dec.compiled
        # edge-id records fit int16 for every phnrec-scale network: half
        # the retained bytes
        self._rec_i16 = max(len(c.in_src), len(c.ex_src),
                            len(dec.decoder.cm) or 1,
                            len(dec.decoder.cs) or 1) < (1 << 15)
        self._id_dtype = torch.int16 if self._rec_i16 else torch.int32
        self._dense = self._net_decode = None
        if c.n_models + c.n_states <= DENSE_MAX:
            self._dense = DenseKWSScan(dec.decoder)
            self._net_decode = netdecode.build_net_decode_fn(self._dense)
        self.net_path = ("kernel_e" if self._net_decode is not None
                         else "kernel_g")
        # per-stream fixed-lag commit state (this rank's streams, sized
        # once the base class has placed the rows): committed labels and
        # the committed path like (0 after each rebase)
        self._stk_committed: List[List[Label]] = []
        self._like0 = np.zeros(0, np.float64)
        self._horizon = (record_horizon if record_horizon is not None
                         else max(4 * dec.time_pruning, 4 * block_frames,
                                  512))
        # commit back-off: when a commit settles nothing (the terminal
        # sink unreachable over a stretch), the next try waits until the
        # window has grown by another horizon instead of walking every
        # block (memory grows until a word settles, as the single-stream
        # path's, which cannot drop unemitted words either)
        self._next_commit_at = 0
        super().__init__(sr, n_streams, block_frames=block_frames,
                         auto_pump=auto_pump, mesh=mesh,
                         partial_pump=partial_pump)
        self._stk_committed = [[] for _ in range(self._nl)]
        self._like0 = np.zeros(self._nl, np.float64)

    # -- decoder hooks ---------------------------------------------------
    def _check_decoder(self, sr) -> None:
        pass                                   # validated in __init__

    def _commits(self) -> bool:
        return True

    def _init_decode_carry(self):
        nl = self._nl
        stk = (self._dense.init_carry_decode(nl, self.device)
               if self._net_decode is not None else
               self._dec.decoder.init_carry(self.device, nl))
        return (stk, torch.full((nl,), self._beam0, device=self.device),
                self._xform_state0())

    def set_beam_pruning(self, v: Optional[float]) -> None:
        """Live beam-pruning knob (SetBeamPruning, stkinterface.h:108)."""
        beam = torch.full((self._nl,), float(OFF_BEAM if v is None else v),
                          device=self.device)
        self._carry = (self._carry[0], beam, self._carry[2])

    def _decode_block(self, carry, lp, n_dec, n_valid):
        dec = self._dec.decoder
        stk_c, beam, xst = carry
        xst, lp = self._apply_xform(xst, lp, n_valid)
        obs = dec.state_observations(lp).contiguous()          # [N, F, E]
        if self._net_decode is not None:
            stk_c, recs = self._net_decode(stk_c, obs, n_valid, beam,
                                           self._id_dtype)
            self._mark("netdecode")
        else:
            # the edge-list scan's valid bound is absolute; only the
            # records the walk reads are kept (not exit_val, sink_wt)
            stk_c, recs = dec.scan_block(stk_c, obs, n_dec, n_dec + n_valid,
                                         beam)
            recs = {k: (recs[k].to(self._id_dtype)
                        if k in netdecode.ID_KEYS else recs[k])
                    for k in netdecode.RECORDS}
            self._mark("netscan")
        return (stk_c, beam, xst), recs

    def _compact_scan(self, hists, skip0, K: int, N: int):
        """The record blocks of one decode_device_buffer run [N, F, .] ->
        [N, K*F, .] with block 0's delay-gate gap removed from every leaf
        (the base class's gather, on the frame axis of each record)."""
        merged = hists[0] if K == 1 else {
            k: torch.cat([h[k] for h in hists], dim=1) for k in hists[0]}
        if skip0.any():
            TT = K * self.block
            j = torch.arange(TT, device=self.device)[None, :]
            sk = torch.as_tensor(skip0, device=self.device)[:, None]
            idx = torch.clamp(j + torch.where(j >= self.block - sk, sk, 0),
                              0, TT - 1)                         # [N, TT]
            merged = {k: torch.gather(a, 1, idx[:, :, None].expand(
                -1, -1, a.shape[2])) for k, a in merged.items()}
        self._mark("compact")
        return merged

    # -- retained-window traceback ---------------------------------------
    def _f0_rel(self) -> np.ndarray:
        """The committed boundary in window-relative frames (-1: the stream
        start, where the t = 0 entry crossing is the utterance's own)."""
        return np.where(self._frame0 > 0, self._frame0 - self._row_offset,
                        -1).astype(np.int32)

    def _device_walk(self) -> Optional[List[List[Label]]]:
        """The retained window's walk on the device: the blocks' valid rows
        concatenated there, then kernel H with each stream's committed
        boundary; only the crossed edges' ids and values come back.  None
        when the blocks are not on the device, stream-uniform, and at one
        row offset (the host walk takes those)."""
        if not self._hist:
            return [[] for _ in range(self._nl)]
        valids = np.stack([v for _, v in self._hist])
        if not isinstance(self._hist[0][0]["entry_val"], torch.Tensor) or \
                not (valids == valids[:, :1]).all() or \
                not (self._row_offset == self._row_offset[0]).all():
            return None
        key = [int(v[0]) for _, v in self._hist]
        recs = {k: torch.cat([h[k][:, :n] for (h, _), n in
                              zip(self._hist, key)], dim=1)
                for k in netdecode.RECORDS}
        n_rel = (self._n_dec[self._rows] - self._row_offset).astype(np.int32)
        f0_rel = self._f0_rel()
        dec = self._dec.decoder
        walk = dec._traceback_batch(recs, self._i32(n_rel), self._i32(f0_rel))
        self._mark("walk")
        ok, sink_edge, sink_val, edges, vals = (x.cpu().numpy()
                                                for x in walk)
        self._mark("fetch")
        return [dec.labels_from_edge_walk(
                    ok[b], sink_edge[b], sink_val[b], edges[b], vals[b],
                    int(n_rel[b]), frame_offset=int(self._row_offset[b]),
                    frame0_rel=max(int(f0_rel[b]), 0),
                    like0=float(self._like0[b]))
                for b in range(self._nl)]

    def _host_walk(self) -> List[List[Label]]:
        """The ragged case: the retained blocks come to the host once
        (they stay there as numpy arrays), and each stream's stitched
        records are walked there (traceback_host with the committed
        boundary)."""
        if not self._hist:
            return [[] for _ in range(self._nl)]
        self._hist = [({k: (a.cpu().numpy() if isinstance(a, torch.Tensor)
                            else a) for k, a in h.items()}, v)
                      for h, v in self._hist]
        dec = self._dec.decoder
        f0_rel = self._f0_rel()
        out: List[List[Label]] = []
        for b in range(self._nl):
            rows = [{k: a[b][: int(v[b])] for k, a in h.items()}
                    for h, v in self._hist if v[b] > 0]
            if not rows:
                out.append([])
                continue
            cut = max(int(f0_rel[b]), 0)
            rec = {k: np.concatenate([r[k] for r in rows])[cut:]
                   for k in rows[0]}
            out.append(dec.traceback_host(
                rec, frame_offset=int(self._row_offset[b]) + cut,
                boundary=bool(self._frame0[b] > 0),
                like_offset=float(self._like0[b])))
        return out

    def _window_walk(self) -> List[List[Label]]:
        w = self._device_walk()
        return self._host_walk() if w is None else w

    def _maybe_commit(self) -> None:
        if self._retained() <= max(self._horizon, self._next_commit_at):
            return
        window = self._window_walk()
        r = np.zeros(self._nl, np.float32)
        for b in range(self._nl):
            horizon = int(self._n_dec[self._lo + b]) - self._dec.time_pruning
            commit = [l for l in window[b] if l.end_frames <= horizon]
            if not commit:
                continue           # nothing settled yet; keep retaining
            self._stk_committed[b].extend(commit)
            r[b] = sum(l.score for l in commit)
            self._frame0[b] = commit[-1].end_frames
        self._drop_committed_blocks()
        if r.any():
            self._rebase_likes(r)
        self._mark("commit")
        retained = self._retained()
        # geometric back-off while nothing settles (see __init__)
        self._next_commit_at = (retained + self._horizon
                                if retained > self._horizon else 0)

    def _rebase_likes(self, r: np.ndarray) -> None:
        """Subtract each stream's newly committed like from its retained
        entry_val / sink_val and its carried alpha / entry, sparing the
        NEG sentinels (a shift would move them off NEG): the recurrence
        is shift-invariant, so cumulative float32 path likes stay bounded
        by the window's like over long sessions.  After the shift the
        committed boundary's like is exactly 0, so ``_like0`` stays 0 and
        the labels' likes are unchanged.  Host blocks shift in numpy."""
        rt = torch.from_numpy(r).to(self.device)

        def shift(a):
            if isinstance(a, np.ndarray):
                rv = r.reshape((self._nl,) + (1,) * (a.ndim - 1))
                np.subtract(a, rv, out=a, where=a > NEG / 2)
                return a
            rv = rt.reshape((self._nl,) + (1,) * (a.dim() - 1))
            return torch.where(a > float(NEG) / 2, a - rv, a)

        self._hist = [(dict(h, entry_val=shift(h["entry_val"]),
                            sink_val=shift(h["sink_val"])), v)
                      for h, v in self._hist]
        stk, beam, xst = self._carry
        if self._net_decode is not None:
            alpha, entry, entry_edge = stk
            stk = (shift(alpha), shift(entry), entry_edge)
        else:
            alpha, wt, entry, entry_edge, entry_wt = stk
            stk = (shift(alpha), wt, shift(entry), entry_edge, entry_wt)
        self._carry = (stk, beam, xst)

    # -- results ---------------------------------------------------------
    def results(self, settled_only: bool = False) -> List[List[Label]]:
        """Per-stream word labels: the committed prefix + the walk over the
        retained window (ViterbiDone per stream); ``settled_only`` keeps
        only labels ending at least time_pruning frames behind the
        stream's newest frame (the fixed-lag callback view)."""
        window = self._window_walk()
        out: List[List[Label]] = []
        for b in range(self._nl):
            labels = self._stk_committed[b] + window[b]
            if settled_only:
                horizon = int(self._n_dec[self._lo + b]) - \
                    self._dec.time_pruning
                labels = [l for l in labels if l.end_frames <= horizon]
            out.append(labels)
        return self._gather(out)
