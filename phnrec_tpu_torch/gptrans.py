"""Grapheme-to-phoneme transduction (reference: gptrans.{cpp,h}).

Copy of phnrec_tpu/gptrans.py (host code without JAX, kept in step with it).

Rules are an AT&T-binary automaton over an alternating-context key: for
grapheme position i the key sequence is word[i], word[i+1], word[i-1],
word[i+2], word[i-2], ... with '+' at word boundaries (CreateKeyIdxs,
gptrans.cpp:211-247).  The automaton is walked greedily by input symbol
(first matching arc); the deepest node reached emits the rules: every
arc from it matching the last consumed symbol yields a phoneme variant
(labelTo, weight) (FindRules, gptrans.cpp:249-295).  Variants multiply
across positions; '-'/'*'/'+' placeholders are stripped from the final
pronunciations (FilterPron), probabilities optionally rescaled so the
best is 1.0, and the list cut by max_variants / prob threshold.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from phnrec_tpu_torch.fsm import FSM
from phnrec_tpu_torch.lexicon import TransEntry


class UnknownGraphemeError(ValueError):
    pass


class GPTranscriber:
    def __init__(self, max_variants: int = -1, prob_thr: float = -1.0,
                 scale_prob: bool = False):
        self.rules: Optional[FSM] = None
        self.symbols: Dict[str, int] = {}
        self.symbols_back: Dict[int, str] = {}
        self.max_variants = max_variants
        self.prob_thr = prob_thr
        self.scale_prob = scale_prob

    @property
    def initialized(self) -> bool:
        return self.rules is not None

    def load_rules(self, path: str) -> None:
        self.rules = FSM.load_bin_att(path)

    def load_symbols(self, path: str) -> None:
        self.symbols.clear()
        self.symbols_back.clear()
        for line in open(path, encoding="latin-1"):
            parts = line.split()
            if len(parts) >= 2:
                self.symbols[parts[0]] = int(parts[1])
                self.symbols_back[int(parts[1])] = parts[0]

    # ------------------------------------------------------------------
    def _key_idxs(self, word_idxs: List[int], i: int) -> List[int]:
        out = []
        boundary = self.symbols["+"]
        left_out = right_out = False
        sign, j = 1, 0
        while not (left_out and right_out):
            if i < 0:
                left_out = True
                out.append(boundary)
            elif i >= len(word_idxs):
                right_out = True
                out.append(boundary)
            else:
                out.append(word_idxs[i])
            i += sign * (j + 1)
            sign *= -1
            j += 1
        return out

    def _find_rules(self, key_idxs: List[int]) -> List[tuple]:
        fsm = self.rules
        node = fsm.start
        last_emit = None
        last_idx = 0
        for sym in key_idxs:
            nxt = fsm.next_node_is(node, sym)
            if nxt is None:
                break
            last_emit, last_idx = node, sym
            node = nxt
        if last_emit is None:
            return [(0, 1.0)]
        return [(a.label_to, a.weight) for a in fsm.arcs_from(last_emit)
                if a.label_from == last_idx]

    @staticmethod
    def _filter_pron(pron: str) -> str:
        out = pron.translate(str.maketrans("-*+", "   "))
        return " ".join(out.split())

    def generate(self, word: str) -> List[TransEntry]:
        if self.rules is None:
            raise RuntimeError("G2P rules not loaded")
        try:
            idxs = [self.symbols[c] for c in word]
        except KeyError as e:
            raise UnknownGraphemeError(str(e))

        variants: List[List] = [["", 1.0]]
        for i in range(len(idxs)):
            rules = self._find_rules(self._key_idxs(idxs, i))
            new_variants = []
            for trans, prob in variants:
                for k, (target, rprob) in enumerate(rules):
                    sym = self.symbols_back.get(target, "")
                    t = sym if trans == "" else f"{trans} {sym}"
                    if k == 0:
                        new_variants.append([t, prob * rprob])
                    else:
                        new_variants.append([t, prob * rprob])
            variants = new_variants

        entries = [TransEntry(self._filter_pron(t), p) for t, p in variants]
        entries.sort(key=lambda e: (-e.prob, e.trans))
        if self.scale_prob and entries:
            best = max(e.prob for e in entries)
            if best > 1e-10:
                for e in entries:
                    e.prob /= best
        out = []
        for e in entries:
            if self.prob_thr == -1.0 or e.prob > self.prob_thr:
                out.append(e)
                if self.max_variants != -1 and len(out) >= \
                        self.max_variants:
                    break
        return out

    def generate_best(self, word: str) -> str:
        entries = self.generate(word)
        return entries[0].trans if entries else ""

    @classmethod
    def from_config(cls, cfg) -> "Optional[GPTranscriber]":
        rules = cfg.get_str("gptransc", "rules")
        symbols = cfg.get_str("gptransc", "symbols")
        if rules in ("", "none") or symbols in ("", "none"):
            return None
        g = cls(max_variants=cfg.get_int("gptransc", "max_variants"),
                prob_thr=cfg.get_float("gptransc", "prob_thr"),
                scale_prob=cfg.get_bool("gptransc", "scale_prob"))
        g.load_rules(rules)
        g.load_symbols(symbols)
        return g
