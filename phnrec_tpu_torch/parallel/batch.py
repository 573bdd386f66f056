"""Batched wav->labels pipeline on one device, or split over a mesh.

Counterpart of phnrec_tpu/parallel/batch.py.  Without a mesh the batch runs
on the one device the pipeline was built for.  With ``mesh`` (a DeviceMesh
with a "data" dimension, parallel/mesh.py) every rank of the data group
runs the same ``run_padded`` call: each runs its contiguous share of the
batch rows on its card, as ``P("data")`` splits them, and the fetched
segments are all-gathered, so every rank returns every row.

    wave [B, L] --frame/mel GEMMs--> params [B, T, D]
      --masked sentence norm--> --LCRC convs--> --MLP kernel x3-->
    log-posteriors [B, T, PS] --Viterbi kernel--> History [T, B]
      --backtrack kernel--> Segments [B, Smax] --host--> labels

Per-utterance true lengths ride along as [B] integers: sentence statistics
mask padded frames, the LCRC context clamps to the last VALID frame
(srec.cpp:877-927), and history rows beyond n_frames[b] are never read by
the backtrack.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from phnrec_tpu_torch import normalization
from phnrec_tpu_torch.decoder import phnloop
from phnrec_tpu_torch.io.audio import ALAW_TABLE_D5
from phnrec_tpu_torch.io.labels import Label
from phnrec_tpu_torch.pipeline import resolve_device
from phnrec_tpu_torch.utils.profiling import TIMER


@dataclass
class BatchResult:
    labels: List[List[Label]]       # per utterance
    n_frames: np.ndarray            # [B]


class BatchPipeline:
    """Batch runner over a SpeechRec's loaded modules.

    ``plain`` runs every kernel's plain version instead, on any device:
    the reference run that the kernels are held against on the card.
    ``stage_hook``, when set, is called with a stage name after each stage
    of ``_core`` (a tracing point; chip_smoke.py records CUDA events
    there)."""

    def __init__(self, sr, device=None, plain: bool = False, mesh=None):
        self.sr = sr
        self.mesh = mesh
        self._axis = None
        if mesh is not None:
            from phnrec_tpu_torch.parallel.mesh import data_axis
            self._axis = data_axis(mesh)
        self.device = (sr.device if device is None
                       else resolve_device(device))
        if self.device != sr.device:
            raise ValueError(f"SpeechRec lives on {sr.device}, not "
                             f"{self.device}")
        self.plain = plain
        self.stage_hook: Optional[Callable[[str], None]] = None
        self._alaw = torch.tensor(8.0 * ALAW_TABLE_D5.astype(np.float32),
                                  device=self.device)

    def _mark(self, stage: str) -> None:
        if self.stage_hook is not None:
            self.stage_hook(stage)

    # -- padding helpers -------------------------------------------------
    def pad_batch(self, waves: Sequence[np.ndarray]) -> Tuple[np.ndarray,
                                                              np.ndarray]:
        """Pad float waveforms to a common length (zeros).  Each waveform
        must already be >= MB_VECTORSIZE samples (io.audio pads)."""
        L = max(w.shape[0] for w in waves)
        out = np.zeros((len(waves), L), np.float32)
        n_samples = np.zeros(len(waves), np.int32)
        for i, w in enumerate(waves):
            out[i, : w.shape[0]] = w
            n_samples[i] = w.shape[0]
        return out, n_samples

    def frame_counts(self, n_samples: np.ndarray) -> np.ndarray:
        spec = self.sr.frontend.spec
        return np.where(
            n_samples <= spec.vector_size, 1,
            (n_samples - spec.vector_size) // spec.step + 1).astype(np.int32)

    # -- device stages ---------------------------------------------------
    def convert_wave(self, wave: torch.Tensor,
                     n_samples: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
        """int16 or A-law uint8 [B, L] -> float32 (ConvertWaveformFormat,
        srec.cpp:709-791, no dither); float32 passes through."""
        sr = self.sr
        if wave.dtype == torch.uint8:
            # 8*ALawTableD5[b] (srec.cpp:769).  No A-law code decodes to 0,
            # so samples past each row's true length are zero-masked to
            # match the reference's float zero-pad (srec.cpp:731-740).
            wave = self._alaw[wave.long()]
            if n_samples is not None:
                t = torch.arange(wave.shape[1], device=wave.device)
                wave = torch.where(t[None, :] < n_samples[:, None], wave, 0.0)
        elif wave.dtype == torch.int16:
            wave = wave.to(torch.float32)
        else:
            return wave
        if sr.wave_dc_shift != 0.0:
            wave = wave + torch.tensor(sr.wave_dc_shift, dtype=torch.float32)
        if sr.wave_scale != 1.0:
            wave = wave * torch.tensor(sr.wave_scale, dtype=torch.float32)
        return wave

    @torch.inference_mode()
    def _post_core(self, wave: torch.Tensor, n_frames: torch.Tensor,
                   max_frames: int,
                   n_samples: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B, L] waves + [B] frame counts -> decoder-ready log posteriors
        [B, T, D] (wave convert + mel + norms + estimator + both softening
        stages)."""
        sr = self.sr
        with TIMER.stage("mel_frontend", block=self.device):
            wave = self.convert_wave(wave, n_samples)
            self._mark("wave_convert")
            par = sr.frontend(wave, max_frames)
            self._mark("frontend")
            par = normalization.frame_norm(par, sr.frame_shift,
                                           sr.frame_floor)
        with TIMER.stage("posteriors", block=self.device):
            par = normalization.sentence_norm(par, sr.sent_norm,
                                              n_valid=n_frames)
            self._mark("norms")
            post = sr.estimator.posteriors_batched(
                par, n_frames, plain=self.plain, mark=self._mark)
            post = sr.post_soft(post)
            out = sr.dec_soft(post)
            self._mark("softening")
        return out

    @torch.inference_mode()
    def _core(self, wave: torch.Tensor, n_frames: torch.Tensor,
              max_frames: int,
              n_samples: Optional[torch.Tensor] = None) -> phnloop.Segments:
        """[B, L] waves + [B] frame counts -> compacted Segments (the full
        wav->mel->LCRC->MLPs->Viterbi->backtrack program on the device).
        A phoneme-loop package's decoder only."""
        self.sr._require_phnloop()
        spec = self.sr.loop_spec
        lp = self._post_core(wave, n_frames, max_frames, n_samples)
        hist = phnloop.viterbi_scan_batch(spec, lp, plain=self.plain)
        self._mark("viterbi")
        segs = phnloop.backtrack_device(spec, hist, n_frames,
                                        plain=self.plain)
        self._mark("backtrack")
        return segs

    # -- public API ------------------------------------------------------
    def to_device(self, wave: np.ndarray, n_samples: np.ndarray):
        """Host batch -> (wave, n_frames, max_frames, n_samples) on the
        device, ready for ``_core``."""
        n_frames = self.frame_counts(n_samples)
        max_frames = int(self.sr.frontend.frame_count(wave.shape[1]))
        dev = self.device
        return (torch.from_numpy(np.ascontiguousarray(wave)).to(dev),
                torch.from_numpy(n_frames).to(dev), max_frames,
                torch.from_numpy(np.asarray(n_samples, np.int32)).to(dev))

    def run_padded(self, wave: np.ndarray, n_samples: np.ndarray
                   ) -> BatchResult:
        n_frames = self.frame_counts(np.asarray(n_samples))
        if self._axis is None:
            w, nf, max_frames, ns = self.to_device(wave, n_samples)
            segs = phnloop.fetch_segments(self._core(w, nf, max_frames, ns))
        else:
            segs = self._run_rows(wave, n_samples)
        labels = phnloop.labels_from_segments(segs, n_frames,
                                              self.sr.phonemes)
        return BatchResult(labels=labels, n_frames=n_frames)

    def _run_rows(self, wave: np.ndarray,
                  n_samples: np.ndarray) -> phnloop.Segments:
        """This rank's rows through ``_core`` (at the whole batch's padded
        length, so max_frames is the unsharded run's), then every rank's
        fetched segments, gathered in row order; slots past a row's count
        are 0, so the ranks' slot counts pad with zeros."""
        from phnrec_tpu_torch.parallel.mesh import all_gather_object, rows_of
        lo, hi = rows_of(wave.shape[0], self._axis)
        mine = None
        if hi > lo:
            w, nf, max_frames, ns = self.to_device(wave[lo:hi],
                                                   n_samples[lo:hi])
            mine = phnloop.fetch_segments(self._core(w, nf, max_frames, ns))
        parts = [p for p in all_gather_object(mine, self._axis)
                 if p is not None]
        k = max(p.phn.shape[1] for p in parts)
        return phnloop.Segments(np.concatenate([p.count for p in parts]), *(
            np.concatenate([np.pad(a, ((0, 0), (0, k - a.shape[1])))
                            for a in leaves])
            for leaves in zip(*(p[1:] for p in parts))))

    def run(self, waves: Sequence[np.ndarray]) -> BatchResult:
        wave, n_samples = self.pad_batch(waves)
        return self.run_padded(wave, n_samples)


def aggregate_metrics(metrics: dict, mesh) -> dict:
    """Sum per-rank counters (audio seconds, frames, edits) over the
    mesh's "data" group: every rank gets the totals."""
    from phnrec_tpu_torch.parallel.mesh import all_reduce, data_axis
    total = all_reduce(metrics.values(), data_axis(mesh))
    return dict(zip(metrics, total))
