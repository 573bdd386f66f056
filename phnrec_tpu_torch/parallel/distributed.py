"""Multi-process data-parallel batch decoding on torch.distributed.

Counterpart of phnrec_tpu/parallel/distributed.py.  The reference
processes file lists serially in one process (ProcessFileList,
srec.cpp:1246-1291).  Here every process of a torch.distributed group runs
the same ``DistributedRunner.run``: the list is sharded over the
processes by index (strided), each shard is bucketed into padded batches
by the prefetching loader and run through the batch pipeline on the
process's card, and the counters are all-reduced.  A progress manifest
makes long runs resumable (each utterance is independent, so resume = skip
completed entries).

The rank and the world size take the place of ``jax.process_index()`` and
``jax.process_count()``, an ``all_reduce`` (SUM, and MAX for the wall
clock) that of ``process_allgather``; the group is NCCL on the card, gloo
on the CPU, and without an initialized group everything behaves as one
process.  With a ``mesh`` (a DeviceMesh with a "data" dimension,
parallel/mesh.py) the ranks of one data group share a list shard and split
each batch's rows, as phnrec_tpu's devices of one host split them; the
list is then sharded over the data groups (rank // group size).  The MLF
is written once, by rank 0, in list order, from every shard's labels.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import torch.distributed as dist

from phnrec_tpu_torch.io.labels import Label, MLFWriter, format_rec_line
from phnrec_tpu_torch.parallel import mesh as meshlib
from phnrec_tpu_torch.parallel.loader import bucket_by_frames  # noqa: F401


def shard_list(entries: Sequence[str], process_index: int,
               process_count: int) -> List[str]:
    """Strided shard: process i handles entries i, i+P, i+2P, ..."""
    return list(entries[process_index::process_count])


@dataclass
class Progress:
    """Resumable progress manifest: one JSON line per completed utterance."""

    path: Optional[str]
    done: Dict[str, int] = field(default_factory=dict)

    @classmethod
    def open(cls, path: Optional[str]) -> "Progress":
        p = cls(path)
        if path and os.path.exists(path):
            with open(path) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                        p.done[rec["source"]] = rec.get("n_labels", 0)
                    except (json.JSONDecodeError, KeyError):
                        continue
        return p

    def mark(self, source: str, n_labels: int, write: bool = True) -> None:
        self.done[source] = n_labels
        if self.path and write:
            with open(self.path, "a") as f:
                f.write(json.dumps({"source": source,
                                    "n_labels": n_labels}) + "\n")


@dataclass
class RunMetrics:
    audio_seconds: float = 0.0
    n_frames: int = 0
    n_utterances: int = 0
    n_labels: int = 0
    wall_seconds: float = 0.0

    def as_dict(self) -> Dict[str, float]:
        d = {k: float(v) for k, v in self.__dict__.items()}
        d["audio_sec_per_s"] = (self.audio_seconds / self.wall_seconds
                                if self.wall_seconds else 0.0)
        return d


def _world():
    """(rank, world size) of the default group, (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def aggregate_across_hosts(metrics: RunMetrics) -> Dict[str, float]:
    """Sum the counters over every process of the default group, the wall
    clock by its maximum; with one process, the identity."""
    vals = [metrics.audio_seconds, metrics.n_frames, metrics.n_utterances,
            metrics.n_labels]
    wall = metrics.wall_seconds
    if _world()[1] > 1:
        axis = meshlib.world_axis()
        vals = meshlib.all_reduce(vals, axis)
        wall = meshlib.all_reduce([wall], axis, dist.ReduceOp.MAX)[0]
    return RunMetrics(*vals, wall).as_dict()


class DistributedRunner:
    """Run a file list wf->str across the processes of a group."""

    def __init__(self, sr, mesh=None, max_batch: int = 64,
                 progress_file: Optional[str] = None):
        from phnrec_tpu_torch.parallel.batch import BatchPipeline
        self.sr = sr
        self.bp = BatchPipeline(sr, mesh=mesh)
        self.max_batch = max_batch
        self.progress = Progress.open(progress_file)

    def _shard(self):
        """(shard index, shard count, this rank's index in its data
        group)."""
        rank, world = _world()
        axis = self.bp._axis
        if axis is None:
            return rank, world, 0
        return rank // axis.size, world // axis.size, axis.rank

    def run(self, list_path: str, mlf_path: Optional[str] = None,
            out_dir: Optional[str] = None) -> Dict[str, float]:
        from phnrec_tpu_torch.parallel.loader import PrefetchLoader

        with open(list_path) as f:
            entries = [line.split()[0] for line in f if line.strip()]
        shard, n_shards, d_rank = self._shard()
        local = shard_list(entries, shard, n_shards)
        local = [e for e in local if e not in self.progress.done]

        sr = self.sr
        metrics = RunMetrics()
        t0 = time.perf_counter()
        # disk reads and waveform conversion run in the loader's worker
        # threads, overlapped with the device work (loader.py)
        loader = PrefetchLoader(
            local, fmt=sr.wave_format, scale=sr.wave_scale,
            dc_shift=sr.wave_dc_shift, noise_level=sr.wave_noise,
            sample_freq=sr.cfg.get_int("source", "sample_freq"),
            max_batch=self.max_batch)
        results: Dict[str, List[Label]] = {}
        for batch in loader:
            res = self.bp.run_padded(batch.wave, batch.n_samples)
            # with a mesh every rank holds every row: each counts the rows
            # it ran, so the sums over all ranks count each row once
            if self.bp._axis is None:
                lo, hi = 0, len(batch.indices)
                metrics.audio_seconds += batch.audio_seconds
            else:
                lo, hi = meshlib.rows_of(len(batch.indices), self.bp._axis)
                metrics.audio_seconds += sum(
                    float(n) / loader.sample_freq
                    for n in batch.n_samples[lo:hi])
            for bi, i in enumerate(batch.indices):
                labels = res.labels[bi]
                results[local[i]] = labels
                self.progress.mark(local[i], len(labels), write=d_rank == 0)
                if lo <= bi < hi:
                    metrics.n_frames += int(res.n_frames[bi])
                    metrics.n_labels += len(labels)
                    metrics.n_utterances += 1
                if out_dir is not None and d_rank == 0:
                    target = sr.compose_target_name(local[i], "str",
                                                    for_mlf=False)
                    with open(os.path.join(out_dir,
                                           os.path.basename(target)),
                              "w") as f:
                        for lab in labels:
                            f.write(format_rec_line(lab) + "\n")
        if mlf_path:
            self._write_mlf(mlf_path, entries, results)
        metrics.wall_seconds = time.perf_counter() - t0
        return aggregate_across_hosts(metrics)

    def _write_mlf(self, mlf_path: str, entries: List[str],
                   results: Dict[str, List[Label]]) -> None:
        """Rank 0 writes every shard's labels, in list order."""
        rank, world = _world()
        if world > 1:
            parts = meshlib.all_gather_object(results, meshlib.world_axis())
            results = {k: v for p in parts for k, v in p.items()}
        if rank != 0:
            return
        with MLFWriter(mlf_path) as mlf:
            for e in entries:
                if e in results:
                    mlf.add(self.sr.compose_target_name(e, "str",
                                                        for_mlf=True),
                            results[e])
