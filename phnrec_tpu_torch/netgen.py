"""Resource generators: phoneme list -> HMM definitions + phoneme-loop
network (reference: netgen.{cpp,h}; run automatically at init when
models/gen_from_phn_list / networks/gen_phn_loop are set,
srec.cpp:336-388).

Copy of phnrec_tpu/netgen.py (host code without JAX, kept in step with it).

Output is byte-compatible with the reference generators so the generated
files interoperate with STK tools (same "%e" float format, same node
numbering with the implicit terminal node 1, netgen.cpp:49-159).
"""

from __future__ import annotations

from typing import List, Optional

from phnrec_tpu_torch.io.weights import load_phoneme_list


def phn_list_to_hmm_defs(phn_list: str, hmm_defs: str,
                         n_states: int) -> None:
    """PhnList2HMMDef (netgen.cpp:22-88): one left-to-right HMM per
    phoneme, <ObsCoef> indices 1..P*S in list order, 0.5/0.5 transitions."""
    assert n_states > 0
    phonemes = _read_whitespace_list(phn_list)
    with open(hmm_defs, "w") as f:
        f.write(f"~o <VecSize> {len(phonemes) * n_states} <PDFObsVec>\n\n")
        st = 1
        for phn in phonemes:
            f.write(f'~h "{phn}"\n<BEGINHMM>\n')
            f.write(f"<NUMSTATES> {n_states + 2}\n")
            for i in range(n_states):
                f.write(f"<STATE> {i + 2} <ObsCoef> {st}\n")
                st += 1
            f.write(f"<TRANSP> {n_states + 2}\n")
            for i in range(n_states + 2):
                row = []
                for j in range(n_states + 2):
                    if i == 0 and j == 1:
                        row.append(f" {1.0:e}")
                    elif i not in (0, n_states + 1) and j in (i, i + 1):
                        row.append(f" {0.5:e}")
                    else:
                        row.append(f" {0.0:e}")
                f.write("".join(row) + "\n")
            f.write("<ENDHMM>\n\n")


def phn_list_to_phn_loop(phn_list: str, phn_loop: str,
                         omit_phn: Optional[str] = None) -> None:
    """PhnList2PhnLoop (netgen.cpp:90-159).  Node layout: 0 = initial null
    (arcs to all models), 1 = terminal (implicit, no line), 2 = loop null
    (arcs to all models + terminal), then per phoneme M-node 2i+3 -> its
    W-node 2i+4 -> node 2."""
    phonemes = [p for p in _read_whitespace_list(phn_list)
                if omit_phn is None or p != omit_phn]
    with open(phn_loop, "w") as f:
        model_ids = " ".join(str(i * 2 + 3) for i in range(len(phonemes)))
        f.write(f"0\t      \t\t\t\t\t {model_ids}\n")
        f.write(f"2\t      \t\t\t\t\t {model_ids} 1\n")
        nid = 3
        for phn in phonemes:
            f.write(f"{nid}\tM={phn:<8}\t\t\t\t{nid + 1}\n")
            nid += 1
            f.write(f"{nid}\tW={phn:<8}\t\t\t\t2\n")
            nid += 1


def _read_whitespace_list(path: str) -> List[str]:
    # fscanf("%s") semantics: any whitespace separates entries
    with open(path, encoding="latin-1") as f:
        return f.read().split()


def generate_resources(cfg) -> None:
    """The init-time generation block (srec.cpp:336-531): HMM defs +
    phoneme loop, and for KWS the lexicon/G2P/keyword-network chain."""
    import os
    if cfg.get_bool("models", "gen_from_phn_list"):
        defs = cfg.get_str("models", "hmm_defs")
        os.makedirs(os.path.dirname(defs) or ".", exist_ok=True)
        phn_list_to_hmm_defs(cfg.get_str("dicts", "phoneme_list"), defs,
                             cfg.get_int("models", "nstates"))
    if cfg.get_bool("networks", "gen_phn_loop"):
        net = cfg.get_str("networks", "default")
        os.makedirs(os.path.dirname(net) or ".", exist_ok=True)
        phn_list_to_phn_loop(cfg.get_str("dicts", "phoneme_list"), net,
                             cfg.get_str("networks", "omit_phn"))
    if cfg.get_bool("networks", "gen_kws_net"):
        from phnrec_tpu_torch.gptrans import GPTranscriber
        from phnrec_tpu_torch.kws import KWSNetGenerator
        from phnrec_tpu_torch.lexicon import Lexicon
        from phnrec_tpu_torch.phntrans import PhnTranscriber

        lex = Lexicon()
        for key, save_key in (("lexicon1", "lexicon1_save_bin"),
                              ("lexicon2", "lexicon2_save_bin")):
            path = cfg.get_str("dicts", key)
            if path not in ("", "none"):
                lex.load(path, save_bin=cfg.get_bool("dicts", save_key))
        gpt = GPTranscriber.from_config(cfg)
        pt = PhnTranscriber(lexicon=lex, gpt=gpt,
                            mode=cfg.get_str("phntransc", "mode"))
        gen = KWSNetGenerator(pt)
        gen.load_phn_list(cfg.get_str("dicts", "phoneme_list"))
        net = cfg.get_str("networks", "default")
        os.makedirs(os.path.dirname(net) or ".", exist_ok=True)
        gen.generate_from_file(cfg.get_str("dicts", "keyword_list"), net)
