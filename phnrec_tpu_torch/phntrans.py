"""Phonetic transcription multiplexer + checker + thresholds.

Copy of phnrec_tpu/phntrans.py (host code without JAX, kept in step with it).

* PhnTranscriber mirrors PhnTrans (phntrans.{cpp,h}): merges lexicon and
  G2P pronunciations under modes lexicon / gpt / union / lexgpt (lexicon
  first, G2P only as fallback), deduplicates identical transcriptions and
  sorts by descending probability (phntrans.cpp:28-127).
* PhnTransChecker (phntranscheck.{cpp,h}): validates transcriptions
  against the phoneme list.
* Thresholds (thresholds.{cpp,h}): per-keyword confidence map with a
  default; live KWS callbacks drop detections below threshold
  (phnrec.cpp:81-83).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

PHNTS_LEXICON, PHNTS_GPT = 0, 1
MODES = ("lexicon", "gpt", "union", "lexgpt")


@dataclass
class PTEntry:
    trans: str
    prob: float
    source: int


class PhnTranscriber:
    def __init__(self, lexicon=None, gpt=None, mode: str = "lexgpt"):
        if mode not in MODES:
            raise ValueError(f"unknown phntransc mode {mode!r}")
        self.lexicon = lexicon
        self.gpt = gpt
        self.mode = mode

    def get_transcs(self, word: str) -> List[PTEntry]:
        out: List[PTEntry] = []
        if self.mode in ("lexicon", "union", "lexgpt") and self.lexicon:
            for e in self.lexicon.get_transcs(word):
                out.append(PTEntry(e.trans, e.prob, PHNTS_LEXICON))
        use_gpt = self.gpt is not None and getattr(
            self.gpt, "initialized", True)
        if use_gpt and (self.mode == "gpt" or self.mode == "union"
                        or (self.mode == "lexgpt" and not out)):
            for e in self.gpt.generate(word):
                out.append(PTEntry(e.trans, e.prob, PHNTS_GPT))
        # dedup identical transcriptions keeping best (phntrans.cpp:81-127)
        out.sort(key=lambda e: (e.trans, e.source, -e.prob))
        dedup: List[PTEntry] = []
        prev = None
        for e in out:
            if e.trans != prev:
                dedup.append(e)
                prev = e.trans
        dedup.sort(key=lambda e: (-e.prob, e.trans, e.source))
        return dedup


class PhnTransChecker:
    def __init__(self):
        self.phn_list: Set[str] = set()

    def load_phn_list(self, path: str) -> None:
        with open(path, encoding="latin-1") as f:
            self.phn_list = set(f.read().split())

    def check(self, trans: str) -> Optional[str]:
        """Return the first unknown phoneme, or None when valid."""
        for phn in trans.split():
            if phn not in self.phn_list:
                return phn
        return None

    @staticmethod
    def transc_len(trans: str) -> int:
        return len(trans.split())


class Thresholds:
    """Keyword confidence thresholds (thresholds.{cpp,h})."""

    def __init__(self, default_thr: float = 0.0):
        self.default_thr = default_thr
        self.thrs: Dict[str, float] = {}

    def load(self, path: str) -> None:
        with open(path, encoding="latin-1") as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    self.thrs[parts[0]] = float(parts[1])

    def get(self, word: str) -> float:
        return self.thrs.get(word, self.default_thr)

    @classmethod
    def from_config(cls, cfg) -> "Thresholds":
        t = cls(default_thr=cfg.get_float("kws", "default_thr"))
        f = cfg.get_str("kws", "thresholds_file")
        if f not in ("", "none"):
            t.load(f)
        return t
