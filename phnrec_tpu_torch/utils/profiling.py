"""Per-stage timing and trace capture on torch devices.

Counterpart of phnrec_tpu/utils/profiling.py, on torch.profiler in place
of jax.profiler:

* ``StageTimer``: named wall-clock accumulators around pipeline stages
  (wave_convert, mel_frontend, posteriors, viterbi, backtrack).  CUDA work
  is asynchronous, so ``stage(name, block=...)`` synchronizes the CUDA
  devices of ``block`` (a tensor, a torch.device, or a tuple, list or dict
  of them) before it stops the clock, so that the device time lands in the
  stage that enqueued it.  A disabled timer does nothing, no sync either,
  and an error from the sync propagates.
* ``trace(log_dir)``: ``torch.profiler.profile`` with the CPU and, where
  there is a card, the CUDA activities, writing a Chrome trace (viewable in
  Perfetto or chrome://tracing) into ``log_dir``; a no-op without a
  directory, so call sites can leave it in.
* ``annotate(name)``: a ``torch.profiler.record_function`` region, plus an
  NVTX range where CUDA is initialized; it shows up inside a captured trace
  and costs little without one.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional

import torch


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
    prof = profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region inside an active profiler trace."""
    nvtx = torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
