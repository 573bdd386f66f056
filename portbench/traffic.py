"""The general traffic generator: a mix file's ``kind`` picks its driver
(``driver_for``: one of the drivers below, else the ``Driver`` class of
``portbench/drivers/<kind>.py``), and its other keys are the driver's
parameters.

``archive``: a corpus of raw lin16 files, decoded to one MLF by the
program's list path (``SpeechRec.process_file_list("wf", "str", list,
mlf)``, what ``phnrec -i wf -o str -l list -m out.mlf`` runs), pass
after pass over the same list.  File lengths are the quantiles of a
lognormal (``median_s``, ``sigma``) clipped to [``min_s``, ``max_s``],
the same set for every seed, in an order and with audio drawn from the
seed.

``live``: ``streams`` concurrent calls staged on the card as int16 (a
seeded base, rolled by ``roll_samples`` a stream), served by
``MultiStreamRecognizer(sr, streams, block_frames, commit_horizon)``
with one ``dispatch_from_device_buffer`` a round; a session is
``session_rounds`` rounds and ``finish()``, and the next session starts
at once (a closed loop replaying a backlog).  The mix's
``package_settings`` (here the online mean norm a live server needs for
nets trained on sentence-normed features) go into the package's config.

Each driver: ``__init__`` makes the inputs (set-up), ``warmup`` runs the
shapes the window uses, ``window`` runs the timed traffic and returns its
end-to-end figures, ``drain`` completes what the window left in flight,
``free`` drops the device inputs, ``judge`` holds what the program
produced to the reference once the program's state is freed.
"""

from __future__ import annotations

import importlib
import os
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.writer import speech_like, write_corpus


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def read_mlf(path: str) -> Dict[str, List[tuple]]:
    """name -> [(start frame, end frame, phoneme, score)] of an MLF."""
    out: Dict[str, List[tuple]] = {}
    cur = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith('"'):
                cur = out.setdefault(line.strip('"'), [])
            elif line == ".":
                cur = None
            elif cur is not None and line:
                s, e, name, score = line.split()[:4]
                cur.append((int(s) // 100000, int(e) // 100000, name,
                            float(score)))
    return out


class Archive:
    def __init__(self, sr, cfg, mix, gen, rng, tmp, device, spans):
        self.sr, self.cfg, self.mix, self.device = sr, cfg, mix, device
        self.spans = spans
        fs = cfg["sample_freq"]
        n = mix["n_files"]
        z = np.array([statistics.NormalDist().inv_cdf((i + 0.5) / n)
                      for i in range(n)])
        secs = np.clip(mix["median_s"] * np.exp(mix["sigma"] * z),
                       mix["min_s"], mix["max_s"])
        self.lengths = rng.permutation(np.round(secs * fs).astype(np.int64))
        self.waves: List[np.ndarray] = []
        chunk: List[int] = []
        for i, ln in enumerate(self.lengths):
            chunk.append(int(ln))
            if sum(chunk) >= mix["chunk_samples"] or i == n - 1:
                a = speech_like(gen, sum(chunk), fs, device).cpu().numpy()
                self.waves += np.split(a, np.cumsum(chunk)[:-1])
                chunk = []
        self.names = [f"u{i:05d}" for i in range(n)]
        self.list_path = write_corpus(os.path.join(tmp, "corpus"),
                                      self.waves, self.names)
        self.mlf = os.path.join(tmp, "out.mlf")
        self.audio_s = float(self.lengths.sum()) / fs
        vs, st = cfg["vector_size"], cfg["vector_step"]
        self.frames = int(np.where(self.lengths <= vs, 1,
                                   (self.lengths - vs) // st + 1).sum())
        # the files the check compares: drawn from the seed, the longest
        k = min(mix["check_files"], n)
        self.pick = sorted(set(rng.choice(n, k, replace=False).tolist())
                           | {int(np.argmax(self.lengths))})

    def _pass(self) -> None:
        self.sr.process_file_list("wf", "str", self.list_path, self.mlf)

    def warmup(self) -> None:
        self._pass()

    def window(self, seconds: float) -> dict:
        walls = []
        t0 = time.perf_counter()
        while True:
            t = time.perf_counter()
            with self.spans("pass"):
                self._pass()
            end = time.perf_counter()
            walls.append(end - t)
            if end - t0 >= seconds:
                break
        wall, passes = end - t0, len(walls)
        return dict(wall_s=wall, item_s=walls,
                    attempted=passes * len(self.names),
                    failed=0, valid_frames=passes * self.frames,
                    metrics=dict(archive_audio_s_per_s=passes * self.audio_s
                                 / wall))

    def drain(self) -> None:
        pass

    def free(self) -> None:
        pass

    def judge(self, ref, judge_fn) -> dict:
        got = read_mlf(self.mlf)
        missing = sum(1 for n in self.names if not got.get(n))
        lps = [ref.log_posteriors(self.waves[i], self.cfg["sent_mean_norm"])
               for i in self.pick]
        out = judge_fn(ref, lps, [got.get(self.names[i], [])
                                  for i in self.pick])
        return dict(out, missing_files=missing, checked=len(self.pick))

    def answers_for(self, ref) -> None:
        """The control in the program's place: the reference's own labels
        of the files the check compares, written as the program's MLF."""
        got = read_mlf(self.mlf) if os.path.exists(self.mlf) else {}
        pick = self.pick
        labs = ref.decode([ref.log_posteriors(self.waves[i],
                                              self.cfg["sent_mean_norm"])
                           for i in pick])
        for i, lab in zip(pick, labs):
            got[self.names[i]] = lab
        with open(self.mlf, "w") as f:
            f.write("#!MLF!#\n")
            for name in self.names:
                f.write(f'"{name}"\n')
                for s, e, ph, sc in got.get(name, []):
                    f.write(f"{s}00000 {e}00000 {ph} {sc:f}\n")
                f.write(".\n")


class Live:
    def __init__(self, sr, cfg, mix, gen, rng, tmp, device, spans):
        self.sr, self.cfg, self.mix, self.device = sr, cfg, mix, device
        self.spans = spans
        N, R = mix["streams"], mix["session_rounds"]
        vs, st = cfg["vector_size"], cfg["vector_step"]
        self.spb = mix["block_frames"] * st
        self.L = R * self.spb + vs - st
        base = speech_like(gen, self.L, cfg["sample_freq"], device)
        self.base = base.cpu().numpy()
        self.audio = torch.empty((N, self.L), dtype=torch.int16,
                                 device=device)
        for s in range(N):
            self.audio[s] = torch.roll(base, -s * mix["roll_samples"])
        self.labels = None
        # the streams the check compares, drawn from the seed
        self.pick = sorted(rng.choice(N, mix["check_streams"],
                                      replace=False).tolist())

    def _server(self):
        from phnrec_tpu_torch.multistream import MultiStreamRecognizer
        return MultiStreamRecognizer(
            self.sr, self.mix["streams"], block_frames=self.mix[
                "block_frames"], commit_horizon=self.mix["commit_horizon"])

    def _round(self, ms, r: int):
        """Round r of a session: the dispatch, its commits, the stream
        synchronised; the session's last round also finishes it."""
        with self.spans("dispatch"):
            ms.dispatch_from_device_buffer(self.audio, r * self.spb)
        _sync(self.device)
        if r == self.mix["session_rounds"] - 1:
            with self.spans("finish"):
                self.labels = ms.finish()

    def warmup(self) -> None:
        ms = self._server()
        for r in range(self.mix["warmup_rounds"]):
            self._round(ms, r)
        ms.finish()
        _sync(self.device)

    def window(self, seconds: float) -> dict:
        R = self.mix["session_rounds"]
        lat, r, ms = [], 0, None
        t0 = time.perf_counter()
        while True:
            t = time.perf_counter()
            if r == 0:
                ms = self._server()
            self._round(ms, r)
            r = (r + 1) % R
            end = time.perf_counter()
            lat.append(end - t)
            if end - t0 >= seconds:
                break
        wall = end - t0
        rounds = len(lat)
        self._in_flight = (ms, r)
        N, B = self.mix["streams"], self.mix["block_frames"]
        audio_s = rounds * N * self.spb / self.cfg["sample_freq"]
        return dict(wall_s=wall, item_s=lat, attempted=rounds * N, failed=0,
                    valid_frames=rounds * N * B,
                    metrics=dict(serve_audio_s_per_s=audio_s / wall))

    def drain(self) -> None:
        """Run the session in flight to its end after the window (untimed,
        untraced), so that its labels can be judged."""
        ms, r = self._in_flight
        while r:
            self._round(ms, r)
            r = (r + 1) % self.mix["session_rounds"]
        _sync(self.device)

    def _wave(self, s: int) -> np.ndarray:
        return np.roll(self.base, -s * self.mix["roll_samples"])

    def _log_posteriors(self, ref, s: int) -> np.ndarray:
        on = self.mix.get("package_settings", {}).get("onlinenorm", {})
        E = int(on.get("estim_interval", 0)) if str(
            on.get("mean_norm", "false")).lower() == "true" else 0
        return ref.log_posteriors(self._wave(s), False, E)

    def free(self) -> None:
        self.audio = None

    def judge(self, ref, judge_fn) -> dict:
        pick = self.pick
        lps = [self._log_posteriors(ref, s) for s in pick]
        labels = [[(l.start_frames, l.end_frames, l.name, l.score)
                   for l in self.labels[s]] if self.labels else []
                  for s in pick]
        return dict(judge_fn(ref, lps, labels), checked=len(pick))

    def answers_for(self, ref) -> None:
        """The control in the program's place: the reference's labels of
        the streams the check samples."""
        from types import SimpleNamespace
        pick = self.pick
        labs = ref.decode([self._log_posteriors(ref, s) for s in pick])
        self.labels = [[] for _ in range(self.mix["streams"])]
        for s, lab in zip(pick, labs):
            self.labels[s] = [SimpleNamespace(start_frames=a, end_frames=b,
                                              name=c, score=d)
                              for a, b, c, d in lab]


DRIVERS = {"archive": Archive, "live": Live}


def driver_for(kind: str):
    """The driver class of a mix's ``kind``: ``DRIVERS[kind]``, else the
    ``Driver`` class of ``portbench/drivers/<kind>.py``, which keeps the
    protocol above (``__init__(sr, cfg, mix, gen, rng, tmp, device,
    spans)``, ``warmup``, ``window``, ``drain``, ``free``, ``judge``,
    ``answers_for``).  What ``window`` returns beyond the keys the drivers
    above return reaches the per-layer readers as ``Trace.extra``."""
    if kind in DRIVERS:
        return DRIVERS[kind]
    module = f"portbench.drivers.{kind}"
    if kind.isidentifier():
        try:
            return importlib.import_module(module).Driver
        except ModuleNotFoundError as e:
            if e.name not in (module, "portbench.drivers"):
                raise
    raise LookupError(
        f"no driver for traffic kind {kind!r}: not in portbench.traffic."
        f"DRIVERS ({', '.join(sorted(DRIVERS))}) and no "
        f"portbench/drivers/{kind}.py")
