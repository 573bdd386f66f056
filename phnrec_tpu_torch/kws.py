"""Keyword-spotting network generation (reference: kwsnetg.{cpp,h}).

Copy of phnrec_tpu/kws.py (host code without JAX, kept in step with it).

Topology (kwsnetg.cpp:181-380): a background phoneme loop (the filler)
whose loop phonemes carry an l=-1 arc penalty, a sticky null node at the
filler output (f=F: the LR denominator), one branch per keyword
pronunciation variant chaining its phones to a sticky keyword-end word
node (f=K: the LR numerator), all feeding the terminal.

Node layout matches the reference writer exactly:
  0 start -> 3;  1 terminal;  2 filler-end sticky (F) -> 1;
  3 loop null -> loop phones + word-starts null + 2;
  4..4+P-1 loop phone models -> 3 (l=-1);
  4+P word-starts null -> each word_B start node;
  word_B start nodes -> first phone of each pronunciation;
  keyword-end nodes (K) -> 1;  pronunciation phone chains.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from phnrec_tpu_torch.phntrans import PhnTranscriber, Thresholds  # re-export

__all__ = ["KWSNetGenerator", "Thresholds"]


class KWSNetGenerator:
    def __init__(self, transcriber: PhnTranscriber):
        self.pt = transcriber
        self.phn_list: List[str] = []

    def load_phn_list(self, path: str) -> None:
        # std::set iteration order = sorted (kwsnetg.h phnList)
        with open(path, encoding="latin-1") as f:
            self.phn_list = sorted(set(f.read().split()))

    def generate_from_file(self, word_list: str, out_file: str) -> None:
        with open(word_list, encoding="latin-1") as f:
            words = sorted(set(f.read().split()))
        self.generate(words, out_file)

    def generate(self, words: Sequence[str], out_file: str) -> None:
        if not self.phn_list:
            raise RuntimeError("phoneme list not loaded")
        prons = {}
        n_phonemes_in_words = 0
        for w in words:
            entries = self.pt.get_transcs(w)
            if not entries:
                raise ValueError(f"no pronunciation for keyword {w!r}")
            prons[w] = entries
            n_phonemes_in_words += sum(len(e.trans.split())
                                       for e in entries)

        P = len(self.phn_list)
        n_nodes = 5 + P + n_phonemes_in_words + 2 * len(words)
        lines: List[str] = [f"N={n_nodes}", "",
                            "#id     wrd/mdl         flag    "
                            "link1 prob1 link2 prob ..."]

        def node(nid: int, typ: str, word: str, flag: str,
                 arcs: List[tuple]) -> None:
            arc_s = " ".join(
                f"{a}" if lm == 0.0 else f"{a} l={lm:f}" for a, lm in arcs)
            flag_s = f"f={flag}\t" if flag else "\t"
            lines.append(f"{nid}\t{typ}={word:<12}\t{flag_s}{arc_s}")

        nid = 0
        node(nid, "W", "!NULL", "", [(3, 0.0)]); nid += 1        # 0 start
        node(nid, "W", "!NULL", "", []); nid += 1                # 1 terminal
        node(nid, "W", "!NULL", "F", [(1, 0.0)]); nid += 1       # 2 filler end
        lines += ["", "#PhnLoop"]
        loop_arcs = [(4 + i, 0.0) for i in range(P)]
        loop_arcs += [(4 + P, 0.0), (2, 0.0)]
        node(nid, "W", "!NULL", "", loop_arcs); nid += 1         # 3 loop null
        for phn in self.phn_list:                                # loop phones
            node(nid, "M", phn, "", [(3, -1.0)]); nid += 1
        lines += ["", "#links to word start nodes"]
        word_starts = [nid + 1 + i for i in range(len(words))]
        node(nid, "W", "!NULL", "",
             [(s, 0.0) for s in word_starts]); nid += 1
        lines += ["", "#word start nodes"]
        # phone chains start after start+end nodes
        chain_base = nid + 2 * len(words)
        idx = chain_base
        for w in words:
            arcs = []
            for e in prons[w]:
                arcs.append((idx, 0.0))
                idx += len(e.trans.split())
            node(nid, "W", f"{w}_B", "", arcs); nid += 1
        lines += ["", "#word end nodes"]
        word_end_ids = {}
        for w in words:
            word_end_ids[w] = nid
            node(nid, "W", w, "K", [(1, 0.0)]); nid += 1
        lines.append("")
        for w in words:
            for e in prons[w]:
                phones = e.trans.split()
                lines.append(f'#wrd "{w}"')
                for j, phn in enumerate(phones):
                    tgt = nid + 1 if j != len(phones) - 1 \
                        else word_end_ids[w]
                    node(nid, "M", phn, "", [(tgt, 0.0)]); nid += 1
                lines.append("")
        with open(out_file, "w") as f:
            f.write("\n".join(lines) + "\n")
