"""Pronunciation lexicon with the reference's text and obfuscated binary
formats (lexicon.{cpp,h}, myrand.{cpp,h}, encode.{cpp,h}).

Copy of phnrec_tpu/lexicon.py (host code without JAX, kept in step with it).

Text format: one ``word<TAB>transcription`` per line (transcription = the
rest of the line, whitespace-separated phonemes).  Multi-part: several
files can load into distinct part numbers; lookups search all parts.

Binary ``.bl`` files are the text content XOR-obfuscated with a stream
from a portable LCG (myrand.cpp:19-22: next = next*1103515245+12345,
output (next>>16)&0x7FFFFFFF; mask = value %% 0xFF, encode.cpp:17-28) with
key 1000 and xor '0' (lexicon.h:35-36).  A .bl next to the text file is
preferred at load; save_bin writes one (lexicon1_save_bin config).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from phnrec_tpu_torch.utils.filename import change_file_suffix

LEX_KEY = 1000
LEX_XOR = ord("0")
LEX_ALLPARTS = -1


def _cipher(data: bytes, key: int = LEX_KEY, xor: int = LEX_XOR) -> bytes:
    """Symmetric XOR-stream obfuscation (rand_encode, encode.cpp:17-28)."""
    out = bytearray(len(data))
    state = key & 0xFFFFFFFF
    for i, b in enumerate(data):
        state = (state * 1103515245 + 12345) & 0xFFFFFFFF
        mask = ((state >> 16) & 0x7FFFFFFF) % 0xFF
        out[i] = b ^ mask ^ xor
    return bytes(out)


@dataclass
class TransEntry:
    trans: str
    prob: float = 1.0


@dataclass
class Lexicon:
    # word -> list of (transcription, prob, part)
    words: Dict[str, List[Tuple[str, float, int]]] = field(
        default_factory=dict)

    def add_word(self, word: str, trans: str, prob: float = 1.0,
                 part: int = 0) -> None:
        self.words.setdefault(word, []).append((trans, prob, part))

    def load(self, path: str, part: int = 0, save_bin: bool = False) -> None:
        bin_path = change_file_suffix(path, "bl")
        if os.path.exists(bin_path):
            self._load_text(_cipher(open(bin_path, "rb").read())
                            .decode("latin-1"), part)
            return
        self._load_text(open(path, encoding="latin-1").read(), part)
        if save_bin and not os.path.exists(bin_path):
            self.save_bin(bin_path, part)

    def _load_text(self, text: str, part: int) -> None:
        for line in text.splitlines():
            parts = line.split(None, 1)
            if not parts:
                continue
            if len(parts) < 2:
                raise ValueError(f"lexicon syntax error at word "
                                 f"{parts[0]!r}")
            self.add_word(parts[0], parts[1].strip(), 1.0, part)

    def save_bin(self, path: str, part: int = 0) -> None:
        lines = []
        for word, entries in self.words.items():
            for trans, _prob, p in entries:
                if p == LEX_ALLPARTS or p == part:
                    lines.append(f"{word}\t{trans}\n")
        data = "".join(lines).encode("latin-1")
        with open(path, "wb") as f:
            f.write(_cipher(data))

    def get_transcs(self, word: str) -> List[TransEntry]:
        return [TransEntry(t, p) for (t, p, _) in self.words.get(word, [])]

    def __contains__(self, word: str) -> bool:
        return word in self.words
