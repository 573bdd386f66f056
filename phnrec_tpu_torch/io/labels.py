"""HTK label (.rec) and Master Label File (MLF) I/O.

Label lines are `start stop name score` with times in 100 ns units.  The
reference prints times as the frame index followed by a literal "00000"
(phndec.cpp:230, srec.cpp:137-161: `%d00000`, with a bare `0` for time 0 in
MLF mode) and scores with printf "%f" (6 decimals).

Copy of phnrec_tpu/io/labels.py.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterable, List, Optional, TextIO


@dataclass
class Label:
    start_frames: int     # frame index (10 ms units)
    end_frames: int
    name: str
    score: float

    @property
    def start_htk(self) -> int:
        return self.start_frames * 100000

    @property
    def end_htk(self) -> int:
        return self.end_frames * 100000


def format_rec_line(lab: Label, mlf_style: bool = False) -> str:
    """One label line.

    - .rec files (phndec.cpp:230): `%d00000 %d00000 name %f` — note frame 0
      prints as `000000`.
    - MLF entries (srec.cpp:137-161): time 0 prints as a bare `0`.
    """
    if mlf_style:
        s = "0" if lab.start_frames == 0 else f"{lab.start_frames}00000"
        e = "0" if lab.end_frames == 0 else f"{lab.end_frames}00000"
    else:
        s = f"{lab.start_frames}00000"
        e = f"{lab.end_frames}00000"
    return f"{s} {e} {lab.name} {lab.score:f}"


def write_rec(path: str, labels: Iterable[Label]) -> None:
    with open(path, "w") as f:
        for lab in labels:
            f.write(format_rec_line(lab) + "\n")


def read_rec(path_or_lines) -> List[Label]:
    if isinstance(path_or_lines, str):
        with open(path_or_lines) as f:
            lines = f.readlines()
    else:
        lines = list(path_or_lines)
    out = []
    for line in lines:
        parts = line.split()
        if len(parts) < 3:
            continue
        start, end, name = int(parts[0]), int(parts[1]), parts[2]
        score = float(parts[3]) if len(parts) > 3 else 0.0
        out.append(Label(start // 100000, end // 100000, name, score))
    return out


class MLFWriter:
    """Master Label File writer (srec.cpp:1260-1287; labels start `#!MLF!#`,
    each utterance is `"name"` then label lines then `.`)."""

    def __init__(self, path: str):
        self._f: Optional[TextIO] = open(path, "w")
        self._f.write("#!MLF!#\n")

    def add(self, name: str, labels: Iterable[Label]) -> None:
        assert self._f is not None
        self._f.write(f'"{name}"\n')
        for lab in labels:
            self._f.write(format_rec_line(lab, mlf_style=True) + "\n")
        self._f.write(".\n")

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class MLFIndex:
    """Byte-offset-indexed random-access MLF reader.

    Stand-in for STKLib's buffered, hash-indexed labelreader
    (labelreader.{cc,h}): one sequential scan records the byte offset of
    every ``"name"`` entry; lookups seek and parse just that transcription.
    Names match HTK-style: exact, by ``*/base.ext`` wildcard entry, or by
    basename stem as a last resort.
    """

    def __init__(self, path: str):
        self.path = path
        self._offsets: dict[str, int] = {}
        self._stems: dict[str, str] = {}
        with open(path, "rb") as f:
            while True:
                off = f.tell()
                line = f.readline()
                if not line:
                    break
                s = line.strip()
                if s.startswith(b'"') and s.endswith(b'"'):
                    name = s[1:-1].decode()
                    self._offsets[name] = off
                    stem = os.path.splitext(
                        os.path.basename(name.lstrip("*/")))[0]
                    self._stems.setdefault(stem, name)

    def __len__(self) -> int:
        return len(self._offsets)

    def names(self) -> List[str]:
        return list(self._offsets)

    def __contains__(self, name: str) -> bool:
        return self._resolve(name) is not None

    def _resolve(self, name: str) -> "Optional[str]":
        if name in self._offsets:
            return name
        base = os.path.basename(name)
        for cand in (f"*/{base}", base):
            if cand in self._offsets:
                return cand
        stem = os.path.splitext(base)[0]
        hit = self._stems.get(stem)
        if hit is not None:
            return hit
        # general wildcard entries, filmatch semantics (filmatch.C)
        from phnrec_tpu_torch.utils.filmatch import is_pattern, match
        for entry in self._offsets:
            if is_pattern(entry) and match(entry, name) is not None:
                return entry
        return None

    def get(self, name: str) -> List[Label]:
        key = self._resolve(name)
        if key is None:
            raise KeyError(f"{name!r} not found in MLF {self.path}")
        labels: List[Label] = []
        with open(self.path) as f:
            f.seek(self._offsets[key])
            f.readline()  # the "name" line itself
            for line in f:
                line = line.strip()
                if line == ".":
                    break
                if line:
                    labels.extend(read_rec([line]))
        return labels


def read_mlf(path: str) -> "dict[str, List[Label]]":
    """Parse an MLF into {utterance name: labels}."""
    out: dict[str, List[Label]] = {}
    cur: Optional[str] = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line == "#!MLF!#" or line == "":
                continue
            if line.startswith('"'):
                cur = line.strip('"')
                out[cur] = []
            elif line == ".":
                cur = None
            elif cur is not None:
                labs = read_rec([line])
                out[cur].extend(labs)
    return out
