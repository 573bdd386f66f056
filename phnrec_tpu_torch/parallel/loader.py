"""Prefetching utterance loader: overlap host I/O with device compute.

The reference reads each file synchronously inside its serial decode loop
(LoadWaveform, srec.cpp:1384-1422 called from ProcessFile srec.cpp:1113).
A serial loop would leave the device idle while the host reads, so the
loader pipelines:

    disk read -> waveform decode -> pad/bucket   (worker threads)
                  -> bounded queue -> consumer (device)

Batches come out in bucket order (few padded shapes), each as
(indices, padded_wave [B, L], n_samples [B]).

Copy of phnrec_tpu/parallel/loader.py, with bucket_by_frames copied in from
phnrec_tpu/parallel/distributed.py (which imports JAX).
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from phnrec_tpu_torch.io import audio
from phnrec_tpu_torch.utils.profiling import count


def bucket_by_frames(lengths: Sequence[int], max_batch: int = 64,
                     granularity: int = 512) -> List[List[int]]:
    """Group utterance indices into batches whose padded lengths share a
    bucket (rounded up to `granularity` samples), so only a few padded
    shapes occur."""
    buckets: Dict[int, List[int]] = {}
    for i, n in enumerate(lengths):
        b = -(-max(n, 1) // granularity) * granularity
        buckets.setdefault(b, []).append(i)
    batches = []
    for b in sorted(buckets):
        idxs = buckets[b]
        for k in range(0, len(idxs), max_batch):
            batches.append(idxs[k : k + max_batch])
    return batches


@dataclass
class LoadedBatch:
    indices: List[int]          # positions in the source list
    sources: List[str]
    wave: np.ndarray            # [B, L] float32, zero-padded
    n_samples: np.ndarray       # [B] int32 true lengths
    audio_seconds: float


class PrefetchLoader:
    """Iterate bucketed, padded waveform batches with background prefetch.

    Bucketing (bucket_by_frames): lengths are rounded up to `granularity`
    samples so at most a handful of padded shapes reach the pipeline.

    Counted (utils/profiling.py): ``loader.batches`` and ``loader.files``
    as the consumer takes them, ``loader.read_s`` the reader threads'
    seconds in ``_build_batch``, summed.
    """

    def __init__(self, sources: Sequence[str], fmt: str = "lin16",
                 scale: float = 1.0, dc_shift: float = 0.0,
                 noise_level: float = 0.0, sample_freq: int = 8000,
                 max_batch: int = 64, granularity: int = 512,
                 prefetch: int = 2, n_workers: int = 4,
                 raw_int16: bool = False, raw_alaw: bool = False):
        """``raw_int16`` ships lin16 batches to the device as int16 and
        leaves the cast + DC shift + scaling to the device pipeline
        (BatchPipeline._core): half the host->device bytes.  Requires fmt == lin16 and noise_level == 0 (dither
        uses the host-side reference LCG, srec.cpp:771-785).

        ``raw_alaw`` does the same for alaw sources, shipping the raw
        uint8 codes (ONE byte per sample — a quarter of pre-converted
        f32) and decoding on device via a 256-entry table gather, which
        reproduces the reference's `8*ALawTableD5[b]` floats exactly
        (srec.cpp:769)."""
        self.sources = list(sources)
        self.fmt = fmt
        self.scale = scale
        self.dc_shift = dc_shift
        self.noise_level = noise_level
        self.sample_freq = sample_freq
        self.max_batch = max_batch
        self.granularity = granularity
        self.prefetch = max(1, prefetch)
        self.n_workers = max(1, n_workers)
        self.raw_int16 = raw_int16
        self.raw_alaw = raw_alaw
        if raw_int16 and (fmt != "lin16" or noise_level != 0.0):
            raise ValueError("raw_int16 requires lin16 input without dither")
        if raw_alaw and (fmt != "alaw" or noise_level != 0.0):
            raise ValueError("raw_alaw requires alaw input without dither")

    # -- single-utterance load (worker side) ------------------------------
    def _load_one(self, src: str) -> Tuple[np.ndarray, int]:
        raw = audio.load_waveform_bytes(src)
        if self.raw_int16:
            sig = np.frombuffer(raw, dtype="<i2")
            if sig.shape[0] < audio.MB_VECTORSIZE:
                sig = np.concatenate(
                    [sig, np.zeros(audio.MB_VECTORSIZE - sig.shape[0],
                                   np.int16)])
            return sig, len(raw) // 2
        if self.raw_alaw:
            sig = np.frombuffer(raw, dtype=np.uint8)
            if sig.shape[0] < audio.MB_VECTORSIZE:
                # no alaw code decodes to 0, so the pad VALUE here is
                # arbitrary: the device pipeline zero-masks samples
                # >= n_samples[b] to reproduce the reference's float
                # zero-pad (srec.cpp:731-740) exactly
                sig = np.concatenate(
                    [sig, np.full(audio.MB_VECTORSIZE - sig.shape[0],
                                  0x55, np.uint8)])
            return sig, len(raw)
        return audio.convert_waveform(raw, self.fmt, scale=self.scale,
                                      dc_shift=self.dc_shift,
                                      noise_level=self.noise_level)

    def _plan(self) -> List[List[int]]:
        """Bucket by file size (known without reading data): size in bytes
        maps monotonically to sample count for both raw formats."""
        import os
        bytes_per = 2 if self.fmt == "lin16" else 1
        lengths = []
        for s in self.sources:
            try:
                n = os.path.getsize(s) // bytes_per
            except OSError:
                n = 1
            lengths.append(max(n, audio.MB_VECTORSIZE))
        return bucket_by_frames(lengths, self.max_batch, self.granularity)

    def _build_batch(self, idxs: List[int]) -> LoadedBatch:
        waves = []
        n_samples = np.zeros(len(idxs), np.int32)
        secs = 0.0
        for k, i in enumerate(idxs):
            w, n = self._load_one(self.sources[i])
            waves.append(w)
            # TRUE sample count (not the MB_VECTORSIZE-padded length):
            # the device alaw mask zeroes samples >= n_samples[b]
            n_samples[k] = n
            secs += n / self.sample_freq
        L = -(-max(w.shape[0] for w in waves) // self.granularity) \
            * self.granularity
        dtype = (np.int16 if self.raw_int16 else
                 np.uint8 if self.raw_alaw else np.float32)
        wave = np.zeros((len(idxs), L), dtype)
        for k, w in enumerate(waves):
            wave[k, : w.shape[0]] = w
        return LoadedBatch(indices=idxs,
                           sources=[self.sources[i] for i in idxs],
                           wave=wave, n_samples=n_samples,
                           audio_seconds=secs)

    # -- iteration ---------------------------------------------------------
    def __iter__(self) -> Iterator[LoadedBatch]:
        plan = self._plan()
        if not plan:
            return
        out: "queue.Queue[object]" = queue.Queue(maxsize=self.prefetch)
        slots: dict[int, Optional[LoadedBatch]] = {}
        slot_lock = threading.Lock()
        next_emit = [0]
        task_q: "queue.Queue[Optional[Tuple[int, List[int]]]]" = queue.Queue()
        for item in enumerate(plan):
            task_q.put(item)
        n_workers = min(self.n_workers, len(plan))
        for _ in range(n_workers):
            task_q.put(None)
        errors: List[BaseException] = []

        def worker():
            while True:
                item = task_q.get()
                if item is None:
                    return
                bi, idxs = item
                t0 = time.perf_counter()
                try:
                    batch = self._build_batch(idxs)
                except BaseException as e:  # surfaced on the consumer side
                    errors.append(e)
                    batch = None
                count("loader.read_s", time.perf_counter() - t0)
                # in-order release: batches may finish out of order but are
                # emitted in plan order
                with slot_lock:
                    slots[bi] = batch
                    while next_emit[0] in slots:
                        out.put(slots.pop(next_emit[0]))  # blocks = backpressure
                        next_emit[0] += 1

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(n_workers)]
        for t in threads:
            t.start()
        emitted = 0
        while emitted < len(plan):
            batch = out.get()
            emitted += 1
            if batch is None:
                for t in threads:
                    t.join()
                raise errors[0]
            count("loader.batches")
            count("loader.files", len(batch.indices))
            yield batch
        for t in threads:
            t.join()
