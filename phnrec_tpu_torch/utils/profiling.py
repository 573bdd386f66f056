"""Per-stage timing, the span recorder and trace capture on torch devices.

Counterpart of phnrec_tpu/utils/profiling.py, on torch.profiler in place
of jax.profiler:

* ``StageTimer``: named wall-clock accumulators around pipeline stages
  (wave_convert, mel_frontend, posteriors, viterbi, backtrack).  CUDA work
  is asynchronous, so ``stage(name, block=...)`` synchronizes the CUDA
  devices of ``block`` (a tensor, a torch.device, or a tuple, list or dict
  of them) before it stops the clock, so that the device time lands in the
  stage that enqueued it.  A disabled timer does nothing, no sync either,
  and an error from the sync propagates.
* ``Recorder`` (``RECORDER``, and its ``span`` and ``count``): spans and
  counters placed inside the program where the work happens (the list
  path, the serving feed, label building, the segment fetch) and the
  garbage collector's collections.  A span records its name, start and
  end (``perf_counter_ns``), the span around it and a request id, and
  while it is open it is a ``torch.profiler.record_function`` range (and
  an NVTX range where CUDA is initialized), so it lands in a profiler
  trace on the same clock as the kernels and copies.  The recorder is on
  while enabled (``enable()``: the CLI's ``--profile`` and ``--trace=``,
  ``trace(log_dir)``) or while a torch.profiler capture runs, and keeps
  each such capture's records apart; off, a span or a count is a few flag
  tests.  ``annotate`` is the span under phnrec_tpu's name.
* ``trace(log_dir)``: ``torch.profiler.profile`` with the CPU and, where
  there is a card, the CUDA activities, writing a Chrome trace (viewable in
  Perfetto or chrome://tracing) into ``log_dir``; a no-op without a
  directory, so call sites can leave it in.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import os
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler


@dataclass
class StageStats:
    calls: int = 0
    seconds: float = 0.0


def _cuda_devices(obj, out: set) -> set:
    """The CUDA devices that ``obj`` (a tensor, a device, or a tuple, list
    or dict of them) lives on."""
    if isinstance(obj, torch.Tensor):
        if obj.device.type == "cuda":
            out.add(obj.device)
    elif isinstance(obj, torch.device):
        if obj.type == "cuda":
            out.add(obj)
    elif isinstance(obj, dict):
        for v in obj.values():
            _cuda_devices(v, out)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            _cuda_devices(v, out)
    return out


@dataclass
class StageTimer:
    stats: Dict[str, StageStats] = field(
        default_factory=lambda: defaultdict(StageStats))
    enabled: bool = True

    @contextlib.contextmanager
    def stage(self, name: str, block: object = None) -> Iterator[None]:
        """Time a stage.  ``block`` names the CUDA work to wait for before
        the clock stops: a tensor, a torch.device, or a collection of
        them."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            for dev in _cuda_devices(block, set()):
                torch.cuda.synchronize(dev)
            s = self.stats[name]
            s.calls += 1
            s.seconds += time.perf_counter() - t0

    def summary(self) -> str:
        total = sum(s.seconds for s in self.stats.values()) or 1.0
        rows = sorted(self.stats.items(), key=lambda kv: -kv[1].seconds)
        lines = [f"{'stage':<16} {'calls':>6} {'seconds':>10} {'%':>6}"]
        for name, s in rows:
            lines.append(f"{name:<16} {s.calls:>6} {s.seconds:>10.4f} "
                         f"{100.0 * s.seconds / total:>5.1f}%")
        return "\n".join(lines)

    def reset(self) -> None:
        self.stats.clear()


# module-level default timer; the pipeline uses this one
TIMER = StageTimer(enabled=False)


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Capture a torch.profiler trace into ``log_dir`` as a Chrome trace
    file, ``trace_<pid>.json`` (None => no-op)."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    was_enabled = RECORDER.enabled
    RECORDER.enable()
    prof = profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        if not was_enabled:
            RECORDER.disable()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}.json"))




class SpanRecord(NamedTuple):
    """One closed span: its number and its parent's in the capture (None
    at the top of a thread), name, request id, start and end
    (``perf_counter_ns``) and self time (ns: the duration less the child
    spans')."""

    seq: int
    parent: Optional[int]
    name: str
    id: object
    start_ns: int
    end_ns: int
    self_ns: int


class SpanStat(NamedTuple):
    count: int
    total_s: float
    self_s: float


@dataclass
class Snapshot:
    """One capture's records: ``spans`` by name, ``within`` by (the
    parent's name, name), ``counters`` by name, and the last
    ``RECORDS_KEPT`` closed spans (``records``)."""

    spans: Dict[str, SpanStat]
    within: Dict[Tuple[Optional[str], str], SpanStat]
    counters: Dict[str, float]
    records: List[SpanRecord]

    def summary(self) -> str:
        lines = [f"{'span':<22} {'count':>6} {'total_s':>10} {'self_s':>10}"]
        for name, st in sorted(self.spans.items(),
                               key=lambda kv: -kv[1].total_s):
            lines.append(f"{name:<22} {st.count:>6} {st.total_s:>10.4f} "
                         f"{st.self_s:>10.4f}")
        lines.append(f"{'counter':<22} {'value':>17}")
        for name, v in sorted(self.counters.items()):
            lines.append(f"{name:<22} {v:>17.6g}")
        return "\n".join(lines)


# closed spans a capture keeps one by one; its sums by name hold them all
RECORDS_KEPT = 65536


class _Capture:
    """The records of one enabled period or one profiler capture: the
    spans' count, total and self ns summed by name and by (the parent's
    name, name) as they close, the counters, and the last
    ``RECORDS_KEPT`` spans themselves, so that a long run keeps a bounded
    size."""

    def __init__(self):
        self.spans: Dict[str, list] = {}
        self.within: Dict[Tuple[Optional[str], str], list] = {}
        self.records: Deque[SpanRecord] = deque(maxlen=RECORDS_KEPT)
        self.counters: Dict[str, float] = {}
        self.seq = itertools.count()

    def add(self, r: SpanRecord, parent: Optional[str]) -> None:
        d = r.end_ns - r.start_ns
        for agg, key in ((self.spans, r.name),
                         (self.within, (parent, r.name))):
            a = agg.get(key)
            if a is None:
                agg[key] = [1, d, r.self_ns]
            else:
                a[0] += 1
                a[1] += d
                a[2] += r.self_ns
        self.records.append(r)


class _Span:
    """An open span: on its thread's stack, a profiler range (and an NVTX
    range where CUDA is initialized)."""

    __slots__ = ("rec", "cap", "name", "id", "seq", "parent", "child_ns",
                 "nvtx", "rf", "t0")

    def __init__(self, rec: "Recorder", cap: _Capture, name: str, id):
        self.rec, self.cap, self.name, self.id = rec, cap, name, id

    def __enter__(self) -> "_Span":
        stack = self.rec._stack()
        self.parent = parent = stack[-1] if stack else None
        if self.id is None and parent is not None:
            self.id = parent.id
        self.seq = next(self.cap.seq)
        self.child_ns = 0
        stack.append(self)
        self.nvtx = torch.cuda.is_initialized()
        if self.nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter_ns()
        self.rf.__exit__(None, None, None)
        if self.nvtx:
            torch.cuda.nvtx.range_pop()
        self.rec._stack().pop()
        d, parent = t1 - self.t0, self.parent
        if parent is not None:
            parent.child_ns += d
        r = SpanRecord(self.seq, None if parent is None else parent.seq,
                       self.name, self.id, self.t0, t1, d - self.child_ns)
        with self.rec._lock:
            self.cap.add(r, None if parent is None else parent.name)


_OFF = contextlib.nullcontext()


class Recorder:
    """Spans and counters in memory, one capture at a time: the spans
    summed by name as they close, the last ``RECORDS_KEPT`` kept whole.

    On while ``enable()``d, or while a torch.profiler capture runs: a span
    or a count that finds the profiler on opens a capture, and the first
    one (or ``snapshot()``) that finds it off closes it, so that a reader
    after a traced window sees that window's records alone.  While a
    capture is open, a ``gc.callbacks`` hook records each generation 1
    and 2 collection as a span ``gc`` and counts generation 0 ones and
    their seconds without a range (counters ``gc.g0``, ``gc.g1``,
    ``gc.g2``, ``gc.collected``, ``gc.g0_s``).  Off, no callback is
    registered and ``span`` returns a shared no-op context."""

    def __init__(self):
        self.enabled = False
        self._cap: Optional[_Capture] = None
        self._last: Optional[_Capture] = None
        # reentrant: a collection's hook may close its span on a thread
        # that holds the lock
        self._lock = threading.RLock()
        self._tls = threading.local()
        self._gc: Optional[tuple] = None

    def span(self, name: str, id=None):
        """A context manager recording the span ``name`` (a no-op while
        the recorder is off).  ``id`` is the request's id; by default the
        enclosing span's."""
        if self.enabled or _autograd_profiler._is_profiler_enabled \
                or self._cap is not None:
            cap = self._capture()
            if cap is not None:
                return _Span(self, cap, name, id)
        return _OFF

    def count(self, name: str, n: float = 1) -> None:
        """Add ``n`` to the counter ``name`` (nothing while off)."""
        if self.enabled or _autograd_profiler._is_profiler_enabled \
                or self._cap is not None:
            cap = self._capture()
            if cap is not None:
                with self._lock:
                    cap.counters[name] = cap.counters.get(name, 0) + n

    def enable(self) -> None:
        """Record until ``disable()``, in a new capture (kept if already
        enabled)."""
        with self._lock:
            if not self.enabled:
                self._close()
                self.enabled = True
                self._open()

    def disable(self) -> None:
        with self._lock:
            self.enabled = False
            self._close()

    def snapshot(self) -> Optional[Snapshot]:
        """The open capture's records, else the last closed one's; None
        before the first."""
        self._capture()
        cap = self._cap or self._last
        if cap is None:
            return None
        stat = lambda agg: {k: SpanStat(c, t * 1e-9, s * 1e-9)  # noqa: E731
                            for k, (c, t, s) in agg.items()}
        with self._lock:
            return Snapshot(stat(cap.spans), stat(cap.within),
                            dict(cap.counters), list(cap.records))

    # -- captures ---------------------------------------------------------
    def _capture(self) -> Optional[_Capture]:
        """The open capture, opened or closed first to follow a profiler
        capture."""
        on = self.enabled or _autograd_profiler._is_profiler_enabled
        if on != (self._cap is not None):
            with self._lock:
                on = self.enabled or _autograd_profiler._is_profiler_enabled
                if on and self._cap is None:
                    self._open()
                elif not on:
                    self._close()
        return self._cap

    def _open(self) -> None:
        self._cap = _Capture()
        gc.callbacks.append(self._on_gc)

    def _close(self) -> None:
        if self._cap is not None:
            gc.callbacks.remove(self._on_gc)
            self._last, self._cap = self._cap, None

    def _stack(self) -> list:
        try:
            return self._tls.stack
        except AttributeError:
            self._tls.stack = stack = []
            return stack

    def _on_gc(self, phase: str, info: dict) -> None:
        """gc.callbacks hook: generation 0 timed and counted, 1 and 2 as
        spans ``gc``; collections are never concurrent."""
        if phase == "start":
            cap = self._cap
            if cap is None or not (self.enabled or
                                   _autograd_profiler._is_profiler_enabled):
                return
            gen = info["generation"]
            if gen == 0:
                self._gc = (cap, gen, time.perf_counter_ns())
            else:
                s = _Span(self, cap, "gc", None)
                s.__enter__()
                self._gc = (cap, gen, s)
            return
        if self._gc is None:
            return
        (cap, gen, started), self._gc = self._gc, None
        c = cap.counters
        if gen == 0:
            c["gc.g0_s"] = c.get("gc.g0_s", 0) + (
                time.perf_counter_ns() - started) * 1e-9
        else:
            started.__exit__(None, None, None)
        key = f"gc.g{gen}"
        c[key] = c.get(key, 0) + 1
        c["gc.collected"] = c.get("gc.collected", 0) + info["collected"]


# module-level default recorder; the program's spans and counters go here
RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
# phnrec_tpu's name for a named profiler region
annotate = span
