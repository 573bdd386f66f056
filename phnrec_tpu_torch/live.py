"""Live audio recognition (reference: RunLive srec.cpp:1438-1490 +
LWFSource OSS capture lwfsource.{cpp,h}).

The reference reads 125 ms chunks from /dev/dsp on a capture thread.
Modern Linux rarely exposes OSS; this frontend reads an explicit source:
a file path (a character device such as /dev/dsp included), or "-" /
"stdin" / None for a raw sample pipe (e.g. ``arecord -f S16_LE -r 8000 -t
raw | python -m phnrec_tpu_torch.cli -c PKG -a``), and feeds 1/8-second
chunks into the port's StreamingRecognizer on ``sr.device``, emitting
settled words through a callback in the reference's three live output
formats (str / strlen / lab, phnrec.cpp:71-110).  Copy of
phnrec_tpu/live.py: a phoneme-loop package decodes through kernels A/A',
C' and D' on the card, a KWS package through A, G and F.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Callable, Optional

from phnrec_tpu_torch.io.labels import Label
from phnrec_tpu_torch.streaming import StreamingRecognizer


class ThreadedCapture:
    """Capture thread + ring buffer (LWFSource, lwfsource.{cpp,h}).

    A daemon thread reads 100 ms frames from the raw byte source into a
    2 s ring (WFS_BUFFERLENGTH/WFS_FRAMELENGTH, lwfsource.cpp:104-106),
    handing bytes to the consumer through a condition variable — a decode
    stall shorter than the ring capacity never drops samples, unlike a
    blocking read on the consumer thread.  Two reference behaviors kept:
    recording STOPS when the ring cannot fit another frame
    (lwfsource.cpp:160-176) and when the source ends; read() then returns
    whatever is buffered and finally b''.
    """

    BUFFER_MS = 2000
    FRAME_MS = 100

    def __init__(self, stream, bytes_per_second: int):
        frame = max(1, bytes_per_second * self.FRAME_MS // 1000)
        self.frame_len = frame
        self.capacity = frame * (self.BUFFER_MS // self.FRAME_MS)
        self._buf = bytearray()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._stream = stream
        self._recording = True
        self._thread = threading.Thread(target=self._capture, daemon=True)
        self._thread.start()

    def _capture(self) -> None:
        while True:
            with self._cond:
                if not self._recording or \
                        len(self._buf) + self.frame_len > self.capacity:
                    self._recording = False
                    self._cond.notify_all()
                    return
            data = self._stream.read(self.frame_len)
            with self._cond:
                if not data:
                    self._recording = False
                    self._cond.notify_all()
                    return
                self._buf.extend(data)
                self._cond.notify_all()

    def read(self, n: int) -> bytes:
        """Blocking read of up to n bytes (empty only after the end)."""
        with self._cond:
            while self._recording and not self._buf:
                self._cond.wait()
            out = bytes(self._buf[:n])
            del self._buf[:n]
            return out

    def close(self) -> None:
        with self._cond:
            self._recording = False
            self._cond.notify_all()


def format_live(label: Label, fmt: str) -> str:
    if fmt == "lab":
        return f"{label.start_htk} {label.end_htk} {label.name} " \
               f"{label.score:f}"
    if fmt == "str":
        return f" {label.name}"
    if fmt == "strlen":
        length = (label.end_htk - label.start_htk) // 100000 + 1
        return f" {label.name}({length})"
    raise ValueError(
        f"Invalid output format: {fmt}. (can be 'lab', 'str', 'strlen')")


def run_live(sr, out_format: str = "str",
             source: Optional[str] = None,
             emit: Optional[Callable[[str], None]] = None,
             max_chunks: Optional[int] = None) -> list:
    """Read raw samples from `source` and print phonemes as they settle."""
    emit = emit or (lambda s: print(s, flush=True))
    bytes_per_sample = 2 if sr.wave_format == "lin16" else 1
    chunk = sr.cfg.get_int("source", "sample_freq") // 8 * bytes_per_sample

    if source in (None, "-", "stdin"):
        stream = sys.stdin.buffer
    else:
        stream = open(source, "rb")

    # audio DEVICES (e.g. /dev/dsp) go through the capture-thread ring so
    # slow decode does not drop samples — exactly the scope of the
    # reference's LWFSource (lwfsource.h:40-80).  Pipes/stdin/files read
    # directly: pipe backpressure is already lossless, and the ring's
    # stop-on-overflow semantics would truncate faster-than-realtime
    # piped input.
    capture = None
    is_chardev = False
    try:
        import stat

        is_chardev = stat.S_ISCHR(os.fstat(stream.fileno()).st_mode)
    except Exception:
        is_chardev = False
    if is_chardev:
        rate = sr.cfg.get_int("source", "sample_freq")
        capture = ThreadedCapture(stream, rate * bytes_per_sample)
        stream_read = capture.read
    else:
        stream_read = stream.read

    # live sessions are unbounded: commit the settled prefix at a
    # generous multiple of the decoder lag so memory stays O(horizon)
    # (the reference's ring holds exactly time_pruning entries,
    # phndec.cpp:191-234; our horizon is deliberately larger so the
    # commit only forces boundaries long after they settle)
    tp = sr.cfg.get_int("decoder", "time_pruning")
    rec = StreamingRecognizer(sr, commit_horizon=max(4 * tp, 512))
    # live KWS drops detections below the per-keyword threshold — the
    # callback filter in phnrec.cpp:81-83; label files keep every candidate
    thr = None
    if sr.stk_decoder is not None and sr.stk_decoder.mode == "kws":
        thr = sr.stk_decoder.keyword_thresholds
    # Emission tracking.  Decode mode: by label identity + a monotone
    # frontier — the full-traceback settled list can retroactively
    # rewrite an early label when the global best path shifts (the
    # reference cannot — it force-commits at the fixed lag), so
    # count-slicing could emit a misaligned stream; a label is emitted
    # once, only if it advances the frontier, and a printed region is
    # never re-emitted or retracted.  KWS mode: hits arrive in FLUSH
    # order, which is NOT end-time order (per-keyword candidates flush
    # independently), and the tracker's hit list is append-only — so
    # count-slicing is exact there and a frontier would drop hits.
    kws_mode = sr.stk_decoder is not None and sr.stk_decoder.mode == "kws"
    emitted_keys: set = set()
    frontier = 0
    emitted_count = 0
    stable_idx = 0     # labels[:stable_idx] are committed AND processed

    def emit_one(lab) -> None:
        # the threshold filter applies to EVERY live emission,
        # including the Done-time flush (phnrec.cpp:81-83)
        if thr is not None and lab.score < thr.get(lab.name):
            return
        emit(format_live(lab, out_format))

    def emit_new(labels) -> None:
        nonlocal frontier, emitted_count, stable_idx
        if kws_mode:
            for lab in labels[emitted_count:]:
                emit_one(lab)
            emitted_count = len(labels)
            return
        # committed prefix first: immutable labels are processed ONCE
        # (and their dedupe keys released), so per-poll work and the key
        # set stay O(window) over an unbounded session, not O(session)
        cc = rec.committed_count
        for lab in labels[stable_idx:cc]:
            key = (lab.start_frames, lab.end_frames, lab.name)
            if key in emitted_keys:
                emitted_keys.discard(key)     # emitted earlier as settled
                continue
            if lab.end_frames <= frontier:
                continue
            frontier = lab.end_frames
            emit_one(lab)
        stable_idx = cc
        for lab in labels[stable_idx:]:
            key = (lab.start_frames, lab.end_frames, lab.name)
            if key in emitted_keys or lab.end_frames <= frontier:
                continue
            emitted_keys.add(key)
            frontier = lab.end_frames
            emit_one(lab)

    n = 0
    try:
        while True:
            data = stream_read(chunk)
            if not data:
                break
            rec.process(data)
            emit_new(rec.results(settled_only=True))
            n += 1
            if max_chunks is not None and n >= max_chunks:
                break
    finally:
        if capture is not None:
            capture.close()
        if stream is not sys.stdin.buffer:
            stream.close()
    final = rec.finish()
    emit_new(final)
    return final
