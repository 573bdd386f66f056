"""Streaming (online) recognition of one stream with carried state.

Counterpart of phnrec_tpu/streaming.py (ProcessOnline/ProcessTail,
srec.cpp:793-927) for the phoneme-loop decoder: audio arrives in chunks of
any size; mel frames come from a carried sample buffer; the LCRC context
is a carried mel tail of 2 * trap_shift frames; the Viterbi carry and the
History extend across blocks of ``block_frames`` frames.  In steady state
a block runs span -> mel -> LCRC windows -> MLPs (kernel A or A') -> the
scan (kernel C with a running t0) as one function; the first block (the
delay gate), online norm (a host state machine) and the tail flush take
the general path.

Semantics as phnrec_tpu's: posterior rows start at mel frame trap_shift
(the reference's delay gate, srec.cpp:829, checked per frame); finish()
repeats the last mel frame trap_shift times (srec.cpp:877-927) and
backtracks the whole history (PhnDec::Done); online normalization
applies, sentence normalization does not (it needs the whole utterance).
results(settled_only=True) keeps the labels ending at least time_pruning
frames before the newest frame (TimePruning, phndec.cpp:191-234), and
``commit_horizon`` commits and drops settled history for unbounded
sessions.

An stkint package streams through the STK network decoder
(StkInterface::ProcessFrame, stkinterface.cpp:214-289;
phnrec_tpu/streaming.py:167-195, 408-583): each block's log-posteriors
pass the global <InputXform>'s delay lines (``StreamingXform``), become
state observations and extend the carried network scan (kernel G at
n = 1).  In decode mode the record blocks stay on the device until a
commit or ``results()`` pulls them; past a retained horizon of
max(4 time_pruning, 4 block_frames, 512) frames a host traceback commits
the labels ending time_pruning frames behind the newest frame and drops
their rows (the reference's TimePruning ring, Viterbi.cc:65-125).  In KWS
mode each block's sink records feed ``DeviceKWSTracker`` (kernel F at
n = 1) on the device, and only its flush events are fetched.

Also here, shared with the multi-stream servers: ``_convert_chunk`` (a
chunk-safe waveform conversion on the host) and
``_make_posterior_block_fn`` (per-stream context windows -> decoder-ready
log-posteriors, for each posterior system), batched over streams instead
of vmapped.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from phnrec_tpu_torch import normalization
from phnrec_tpu_torch.decoder import phnloop
from phnrec_tpu_torch.decoder.stknet import OFF_BEAM, DeviceKWSTracker
from phnrec_tpu_torch.io import audio
from phnrec_tpu_torch.io.labels import Label
from phnrec_tpu_torch.io.xform import StreamingXform
from phnrec_tpu_torch.posteriors.estimator import sln


def _convert_chunk(raw: bytes, sr) -> np.ndarray:
    """Chunk-safe waveform conversion (no 200-sample min padding — that is
    a whole-file concern handled by io.audio.convert_waveform)."""
    if sr.wave_format == "lin16":
        wave = np.frombuffer(raw, dtype="<i2").astype(np.float32)
    else:
        wave = 8.0 * audio.ALAW_TABLE_D5[
            np.frombuffer(raw, dtype=np.uint8)].astype(np.float32)
    if sr.wave_dc_shift != 0.0:
        wave = wave + np.float32(sr.wave_dc_shift)
    if sr.wave_scale != 1.0:
        wave = wave * np.float32(sr.wave_scale)
    return wave


def _make_posterior_block_fn(sr):
    """[N, 2s+F, nbanks] per-stream context -> [N, F, n_out] log-posteriors,
    batched over streams (phnrec_tpu/streaming.py:599-645, vmapped there).
    LCRC: the 31-frame windows gathered per frame, each side's taps applied
    as one contraction, then the band and merger nets (kernel A).  3BT /
    1BT / 1BT_DCT: the windows are shifted views of the context, and the
    estimator's merger input (the band stack, or the DCT) feeds the
    merger.  Both softenings follow."""
    est = sr.estimator
    width = 2 * est.trap_shift + 1
    if not hasattr(est, "assembler"):
        def run_traps(ctx: torch.Tensor) -> torch.Tensor:
            win = ctx.unfold(1, width, 1).transpose(-1, -2)  # [N, F, 31, nb]
            post = est.merger(est.merger_input(win), est.fast_exp)
            return sr.dec_soft(sr.post_soft(post))

        return run_traps

    asm = est.assembler
    hc = asm.half_context

    def run(ctx: torch.Tensor) -> torch.Tensor:
        N, T, _ = ctx.shape
        F = T - 2 * est.trap_shift
        idx = (torch.arange(F, device=ctx.device)[:, None]
               + torch.arange(width, device=ctx.device)[None, :])
        win = ctx[:, idx]                              # [N, F, 31, nb]
        left = torch.einsum("ntjb,jc->ntbc", win[:, :, :hc], asm.m_left)
        right = torch.einsum("ntjb,jc->ntbc", win[:, :, hc - 1:],
                             asm.m_right)
        lo = est.band[0](left.reshape(N, F, -1), est.fast_exp)
        ro = est.band[1](right.reshape(N, F, -1), est.fast_exp)
        post = est.merger(sln(torch.cat([lo, ro], dim=-1)), est.fast_exp)
        return sr.dec_soft(sr.post_soft(post))

    return run


class StreamingRecognizer:
    """Chunked phoneme-loop recognition of one stream on ``sr.device``."""

    def __init__(self, sr, block_frames: int = 128,
                 commit_horizon: Optional[int] = None):
        """``commit_horizon`` (phoneme loop only): opt-in fixed-lag commit
        for unbounded live sessions: labels ending at least that many
        frames behind the newest frame are committed and their history
        blocks dropped (the reference's TimePruning ring,
        phndec.cpp:191-234; the stkint path commits by its record
        horizon).  None keeps the whole history."""
        if sr.estimator is None:
            raise ValueError("streaming requires an enabled estimator")
        self.sr = sr
        self.device = sr.device
        self.block = block_frames
        self.commit_horizon = commit_horizon
        # fixed-lag commit state: committed labels, boundary frame, path
        # like at the boundary, global frame of the first retained row
        self._committed: List[Label] = []
        self._frame0 = 0
        self._alpha0 = 0.0
        self._row_offset = 0
        spec = sr.frontend.spec
        self.vs, self.step = spec.vector_size, spec.step
        self.trap_shift = sr.estimator.trap_shift
        self.online_norm = normalization.OnlineNorm.from_config(
            sr.cfg, spec.nbanks)
        self.online_norm.set_channel(
            sr.cfg.get_int("onlinenorm", "channel"))

        # lin16 without dither ships int16 to the device; dither needs the
        # host LCG (srec.cpp:771-785), A-law converts via the host table
        self._i16 = (sr.wave_format == "lin16" and sr.wave_noise == 0.0)
        self._sample_buf = np.zeros(0, np.int16 if self._i16 else np.float32)
        self._byte_rem = b""
        self._mel_tail = None                       # [2 * shift, nbanks]
        self._mel_pending = torch.zeros((0, spec.nbanks), device=self.device)
        self._last_mel = None
        self._n_mel = 0           # mel frames fed to the LCRC window so far
        self._carry = phnloop.init_carry(sr.loop_spec, 1, self.device)
        # per block: device or host arrays of the History fields
        self._hist: List[list] = [[], [], []]
        self._n_decoded = 0
        self._post_fn = _make_posterior_block_fn(sr)

        # the stkint decoder: carried network state, record blocks, the
        # committed prefix (decode mode) or the device tracker (KWS mode)
        self._stk = sr.stk_decoder
        self._stk_recs: List[dict] = []   # device record blocks, unpulled
        self._stk_tail = None             # host records of retained rows
        self._stk_frame0 = 0              # absolute frame of retained row 0
        self._stk_committed: List[Label] = []
        self._stk_like0 = 0.0             # cumulative like at the commit
        self._kws_tracker = None
        self._kws_hits_emitted = 0
        self._stk_xform = None
        if self._stk is not None:
            self._stk_carry = self._stk.decoder.init_carry(self.device, 1)
            self._stk_horizon = max(4 * self._stk.time_pruning,
                                    4 * block_frames, 512)
            if self._stk.mode == "kws":
                c = self._stk.compiled
                self._kws_tracker = DeviceKWSTracker(
                    self._stk.keywords(), self._stk.time_pruning,
                    self._stk.kws_score_pruning,
                    word_sinks=c.kws_word_sinks,
                    filler_sink=c.kws_filler_sink, device=self.device)
            # a global <InputXform>'s delay lines carried across blocks
            if self._stk.model_set.input_xform is not None:
                self._stk_xform = StreamingXform(
                    self._stk.model_set.input_xform, device=self.device)

    @property
    def committed_count(self) -> int:
        """Leading labels of results() that are committed (immutable):
        live emitters can skip re-scanning them on every poll."""
        return len(self._stk_committed if self._stk is not None
                   else self._committed)

    def set_channel(self, cid: int) -> None:
        """Switch the online-normalization channel for subsequent audio
        (Normalization::SetChannel, norm.cpp:202).  Pending full mel
        blocks drain under the old channel first; samples not yet forming
        a full block normalize under the new one."""
        if self.online_norm.enabled:
            self._drain()
        self.online_norm.set_channel(cid)

    # -- waveform -> mel frames -----------------------------------------
    def _front(self, span: np.ndarray) -> torch.Tensor:
        """Host samples [L] -> normalized mel frames [F, nbanks] on the
        device; the int16 path applies dc shift and scale there (the float
        path had them in _convert_chunk)."""
        sr = self.sr
        w = torch.from_numpy(span).to(self.device).to(torch.float32)
        if self._i16 and sr.wave_dc_shift != 0.0:
            w = w + torch.tensor(sr.wave_dc_shift, dtype=torch.float32)
        if self._i16 and sr.wave_scale != 1.0:
            w = w * torch.tensor(sr.wave_scale, dtype=torch.float32)
        n = (span.shape[0] - self.vs) // self.step + 1
        par = sr.frontend(w[None], n)[0]
        return normalization.frame_norm(par, sr.frame_shift, sr.frame_floor)

    def _decode(self, lp: torch.Tensor, n_rows: int) -> None:
        """Extend the scan by the rows of ``lp`` [T, D] (kernel C, the
        running frame offset as t0 so History.ent stays global; an stkint
        package's network scan); the caller counts ``n_rows`` of them as
        decoded."""
        if self._stk is not None:
            self._run_stk_block(lp[:n_rows])
            self._n_decoded += n_rows
            return
        self._carry, hist = phnloop.viterbi_block(
            self.sr.loop_spec, self._carry, lp[None], self._n_decoded)
        for i, a in enumerate(hist):
            self._hist[i].append(a[:, 0])
        self._n_decoded += n_rows

    def process(self, raw: bytes) -> None:
        """Push a chunk of raw audio bytes (any size, odd ones included)."""
        sr = self.sr
        if sr.wave_format == "lin16":
            raw = self._byte_rem + raw
            cut = len(raw) - (len(raw) % 2)
            raw, self._byte_rem = raw[:cut], raw[cut:]
            wave = (np.frombuffer(raw, dtype="<i2") if self._i16
                    else _convert_chunk(raw, sr))
        else:
            wave = _convert_chunk(raw, sr)
        self._sample_buf = np.concatenate([self._sample_buf, wave])
        # consume full blocks of frames straight from the sample buffer;
        # leftovers wait for the next chunk or finish()
        spb = self.block * self.step
        need = (self.block - 1) * self.step + self.vs
        ts2 = 2 * self.trap_shift
        while self._sample_buf.shape[0] >= need:
            span = self._sample_buf[:need]
            self._sample_buf = self._sample_buf[spb:]
            if (not self.online_norm.enabled and self._mel_tail is not None
                    and self._n_mel >= self.trap_shift):
                # steady state: the whole block in one pass
                par = self._front(span)                     # [block, nb]
                ctx = torch.cat([self._mel_tail, par])
                self._mel_tail = ctx[-ts2:]
                self._last_mel = par[-1]
                self._n_mel += self.block
                self._decode(self._post_fn(ctx[None])[0], self.block)
                self._maybe_commit()
            else:
                self._push_mel(self._norm_host(self._front(span)))

    def _norm_host(self, par: torch.Tensor) -> torch.Tensor:
        if self.online_norm.enabled:
            par = torch.from_numpy(self.online_norm.process_block(
                par.cpu().numpy())).to(self.device)
        return par

    def _flush_samples(self) -> None:
        """Frame whatever samples remain (< one block) at finish time."""
        buf = self._sample_buf
        if buf.shape[0] < self.vs:
            return
        n = (buf.shape[0] - self.vs) // self.step + 1
        self._sample_buf = buf[n * self.step:]
        self._push_mel(self._norm_host(
            self._front(buf[: (n - 1) * self.step + self.vs])))

    # -- mel frames -> posteriors -> viterbi -----------------------------
    def _push_mel(self, par: torch.Tensor) -> None:
        if par.shape[0] == 0:
            return
        self._last_mel = par[-1]
        if self._mel_tail is None:
            # replicate-first-frame window init (traps.cpp:186-199)
            self._mel_tail = par[:1].expand(2 * self.trap_shift, -1)
        self._mel_pending = torch.cat([self._mel_pending, par])
        self._drain()

    def _drain(self) -> None:
        while self._mel_pending.shape[0] >= self.block:
            blk = self._mel_pending[: self.block]
            self._mel_pending = self._mel_pending[self.block:]
            self._run_block(blk, blk.shape[0])

    def _run_block(self, blk: torch.Tensor, n_valid: int) -> None:
        """blk [F, nbanks] new mel frames: posterior rows for the windows
        centred trap_shift back, then the scan over the valid ones."""
        ctx = torch.cat([self._mel_tail, blk])
        self._mel_tail = ctx[-2 * self.trap_shift:]
        lp = self._post_fn(ctx[None])[0][:n_valid]
        # rows are window centres n_mel - shift .. n_mel + F - shift - 1;
        # those before frame 0 are the delay gate's
        skip = min(max(self.trap_shift - self._n_mel, 0), lp.shape[0])
        self._n_mel += n_valid
        lp = lp[skip:]
        if lp.shape[0] == 0:
            return
        self._decode(lp, lp.shape[0])
        self._maybe_commit()

    # -- fixed-lag commit (commit_horizon) --------------------------------
    def _hist_host(self) -> List[np.ndarray]:
        """The retained History on the host, one array per field (blocks
        still on the device are fetched and kept as host arrays)."""
        self._hist = [[a.cpu().numpy() if isinstance(a, torch.Tensor) else a
                       for a in h] for h in self._hist]
        return [np.concatenate(h)[: self._n_decoded - self._row_offset]
                for h in self._hist]

    def _maybe_commit(self) -> None:
        """Fixed-lag commit of the retained history (commit_horizon):
        backtrack the window, move labels ending behind the horizon into
        the committed prefix, drop blocks whose rows are all committed.
        The commit is forced, like the reference's ring: a label spanning
        the whole horizon is split at it (its like telescopes exactly).
        Committed scores are rebased out of the carry."""
        if self.commit_horizon is None or self._stk is not None:
            return
        retained = self._n_decoded - self._row_offset
        if retained <= 2 * self.commit_horizon + self.block:
            return
        hist = phnloop.History(*self._hist_host())
        labels = phnloop.backtrack_committed(
            hist, self._row_offset, self._frame0, self._alpha0,
            self.sr.phonemes)
        horizon_end = self._n_decoded - self.commit_horizon
        got = phnloop.commit_labels(labels, horizon_end, lambda: float(
            hist.alpha[horizon_end - 1 - self._row_offset]) - self._alpha0)
        if got is None:
            return
        commit, self._frame0, self._alpha0 = got
        self._committed.extend(commit)
        while self._hist[0]:
            blk_len = len(self._hist[0][0])
            if self._row_offset + blk_len > self._frame0:
                break
            for h in self._hist:
                h.pop(0)
            self._row_offset += blk_len
        self._rebase_alphas()

    def _rebase_alphas(self) -> None:
        """Subtract the committed like from every retained score and the
        carried alphas, sparing the -FLT_MAX sentinels (a shift would
        overflow them to -inf): the recurrence is shift-invariant, and
        |alpha| stays bounded by the window's like."""
        r = np.float32(self._alpha0)
        if r == 0.0:
            return
        alphas, ent = self._carry
        self._carry = (torch.where(alphas <= float(phnloop.NEG_INF / 2),
                                   alphas, alphas - float(r)), ent)
        self._hist[2] = [a - (r if isinstance(a, np.ndarray) else float(r))
                         for a in self._hist[2]]
        self._alpha0 = 0.0

    # -- end of stream ---------------------------------------------------
    def _flush_blocks(self) -> None:
        self._drain()
        if self._mel_pending.shape[0] > 0:
            blk = self._mel_pending
            self._mel_pending = blk[:0]
            pad = self.block - blk.shape[0]
            padded = torch.cat([blk, blk[-1:].expand(pad, -1)]) \
                if pad > 0 else blk
            self._run_block(padded, blk.shape[0])

    def finish(self) -> List[Label]:
        """ProcessTail + Done: flush the LCRC latency and backtrack (an
        stkint package: the general path, in blocks, as phnrec_tpu)."""
        if (self._stk is None and not self.online_norm.enabled
                and self._mel_tail is not None
                and self._n_mel >= self.trap_shift):
            # the whole tail in one pass: the leftover frames, then the
            # last valid mel frame repeated trap_shift times (repeat-last
            # is a clipped gather; row 0, the mel tail's last, serves
            # n == 0)
            buf = self._sample_buf
            n = ((buf.shape[0] - self.vs) // self.step + 1
                 if buf.shape[0] >= self.vs else 0)
            rows = [self._mel_tail[-1:]]
            if n:
                rows.append(self._front(buf[: (n - 1) * self.step + self.vs]))
            self._sample_buf = buf[n * self.step:]
            idx = torch.clamp(torch.arange(n + self.trap_shift,
                                           device=self.device) + 1, 0, n)
            ctx = torch.cat([self._mel_tail, torch.cat(rows)[idx]])
            self._n_mel += n
            self._decode(self._post_fn(ctx[None])[0], n + self.trap_shift)
            return self.results()
        self._flush_samples()
        if self._last_mel is None:
            return []
        # repeat the last mel frame trap_shift times (srec.cpp:889-898)
        self._mel_pending = torch.cat(
            [self._mel_pending,
             self._last_mel[None].expand(self.trap_shift, -1)])
        self._flush_blocks()
        return self.results()

    def results(self, settled_only: bool = False) -> List[Label]:
        """The committed prefix and the backtrack of the retained history;
        with ``settled_only``, only labels ending at least time_pruning
        frames before the newest frame.  KWS mode: the hits flushed so far,
        in flush order (``settled_only``), or all of them after the final
        flush."""
        if self._stk is not None:
            return self._stk_results(settled_only)
        if not self._hist[0]:
            return list(self._committed)
        hist = phnloop.History(*self._hist_host())
        labels = self._committed + phnloop.backtrack_committed(
            hist, self._row_offset, self._frame0, self._alpha0,
            self.sr.phonemes)
        if settled_only:
            tp = self.sr.cfg.get_int("decoder", "time_pruning")
            horizon = self._n_decoded - tp
            labels = [l for l in labels if l.end_frames <= horizon]
        return labels

    # -- the stkint decoder (StkInterface::ProcessFrame) -------------------
    def _run_stk_block(self, lp: torch.Tensor) -> None:
        """Rows ``lp`` [F, D] through the <InputXform>, the state
        observations and one block of the carried network scan (kernel G
        at n = 1); KWS mode feeds the sink records to the tracker, decode
        mode keeps the records on the device and may commit."""
        dec = self._stk
        obs = self._stk_xform(lp) if self._stk_xform is not None else lp
        obs_state = dec.decoder.state_observations(obs)
        beam = OFF_BEAM if dec.beam_pruning is None else dec.beam_pruning
        F = obs_state.shape[0]
        self._stk_carry, recs = dec.decoder.scan_block(
            self._stk_carry, obs_state[None], self._n_decoded,
            self._n_decoded + F, beam)
        recs = {k: v[0] for k, v in recs.items()}
        if self._kws_tracker is not None:
            self._kws_tracker.feed_sinks(recs["sink_val"], recs["sink_wt"])
        else:
            self._stk_recs.append(recs)
            self._stk_commit()

    def _stk_pull(self) -> None:
        """Move the pending device record blocks onto the host tail (one
        concatenation a call; the commit keeps the tail bounded)."""
        if not self._stk_recs:
            return
        blocks = [{k: v.cpu().numpy() for k, v in r.items()}
                  for r in self._stk_recs]
        self._stk_recs = []
        if self._stk_tail is not None:
            blocks.insert(0, self._stk_tail)
        self._stk_tail = (blocks[0] if len(blocks) == 1 else
                          {k: np.concatenate([b[k] for b in blocks])
                           for k in blocks[0]})

    def _stk_retained(self) -> int:
        return (0 if self._stk_tail is None
                else self._stk_tail["in_am"].shape[0]) + \
            sum(int(r["in_am"].shape[0]) for r in self._stk_recs)

    def _stk_commit(self) -> None:
        """Fixed-lag commit (the reference's TimePruning ring,
        Viterbi.cc:65-125, stkinterface.cpp:222-238): once the retained
        window passes the horizon, walk it back on the host, move the
        labels ending time_pruning frames before the newest frame into the
        committed prefix and drop their rows.  A later shift of the best
        path cannot rewrite the committed prefix, as in the reference."""
        if self._stk_retained() <= self._stk_horizon:
            return
        self._stk_pull()
        labels = self._stk.decoder.traceback_host(
            self._stk_tail, frame_offset=self._stk_frame0,
            boundary=self._stk_frame0 > 0, like_offset=self._stk_like0)
        horizon = self._n_decoded - self._stk.time_pruning
        commit = [l for l in labels if l.end_frames <= horizon]
        if not commit:
            return              # nothing settled yet; keep retaining
        cut_abs = commit[-1].end_frames
        self._stk_committed.extend(commit)
        self._stk_like0 += sum(l.score for l in commit)
        cut = cut_abs - self._stk_frame0
        self._stk_tail = {k: v[cut:] for k, v in self._stk_tail.items()}
        self._stk_frame0 = cut_abs

    def _stk_results(self, settled_only: bool) -> List[Label]:
        if self._kws_tracker is not None:
            # flush order (the live callback order); results(False) is the
            # end of the utterance: flush the rest
            if settled_only:
                self._kws_tracker.collect()
            else:
                self._kws_tracker.finish()
            return [Label(h.start, h.end, h.word, h.score)
                    for h in self._kws_tracker.hits]
        # the committed prefix and a walk over the bounded retained window
        self._stk_pull()
        if self._stk_tail is None:
            return list(self._stk_committed)
        labels = self._stk_committed + self._stk.decoder.traceback_host(
            self._stk_tail, frame_offset=self._stk_frame0,
            boundary=self._stk_frame0 > 0, like_offset=self._stk_like0)
        if settled_only:
            horizon = self._n_decoded - self._stk.time_pruning
            labels = [l for l in labels if l.end_frames <= horizon]
        return labels

    def kws_hits_so_far(self) -> List[Label]:
        """The KWS hits flushed since the last call (the live callback
        stream, DECMSG_WORD per PutKWSCandidateToLabels)."""
        if self._kws_tracker is None:
            return []
        self._kws_tracker.collect()
        new = self._kws_tracker.hits[self._kws_hits_emitted:]
        self._kws_hits_emitted = len(self._kws_tracker.hits)
        return [Label(h.start, h.end, h.word, h.score) for h in new]
