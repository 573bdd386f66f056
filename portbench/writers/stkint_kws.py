"""An stkint keyword-spotting package of an LCRC system: the LCRC
package of ``portbench/writer.py`` (its nets by ``_net``, ``save_nbin``,
input norms measured on ``speech_like`` audio, the seed's order of
hidden units and phonemes), with its own config text (``[decoder]
type=stkint``, ``mode=kws``, the network and the HMM set generated at
load time from the phoneme list, as BUT PhnRec's KWS packages run), and
a keyword list and lexicon drawn from the run's seed.

The keywords: for each length in ``keyword_lengths``,
``keywords_per_length`` keywords of that many phonemes drawn from the
package's phonemes, one pronunciation each, named kw000, kw001, ...  in
a seeded order of lengths.  A fixed multiset of lengths keeps the
generated network's models + states the same on every seed."""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import torch

from portbench import writer

# the stkint KWS lines (the program's synth.KWS_CONFIG), and LRTrace's
# time pruning; beam and score pruning keep the package defaults (off)
KWS_CONFIG = """\
[decoder]
mode=kws
time_pruning={time_pruning}
[networks]
gen_kws_net=true
default=$T/kwsnet
[dicts]
keyword_list=$C/kwlist
lexicon1=$C/kwlex
[models]
gen_from_phn_list=true
hmm_defs=$T/models
"""


def draw_keywords(cfg: dict, gen: torch.Generator, device
                  ) -> Dict[str, str]:
    """name -> its phonemes (space-separated), from ``gen``."""
    lengths = [n for n in cfg["keyword_lengths"]
               for _ in range(cfg["keywords_per_length"])]
    order = torch.randperm(len(lengths), generator=gen,
                           device=device).tolist()
    out = {}
    for i, j in enumerate(order):
        ph = torch.randint(cfg["n_phonemes"], (lengths[j],), generator=gen,
                           device=device).tolist()
        out[f"kw{i:03d}"] = " ".join(f"ph{p:02d}" for p in ph)
    return out


def write_package(root, cfg: dict, gen: torch.Generator, device,
                  settings: dict = None) -> str:
    """The KWS package of the configuration under ``root``; returns its
    path."""
    pkg = Path(writer.write_package(root, cfg, gen, device, settings))
    (pkg / "tmp").mkdir(exist_ok=True)
    text = (pkg / "config").read_text().replace("type=phndec",
                                                "type=stkint")
    (pkg / "config").write_text(text + KWS_CONFIG.format(
        time_pruning=cfg["time_pruning"]))
    words = draw_keywords(cfg, gen, device)
    (pkg / "kwlist").write_text("".join(f"{w}\n" for w in words))
    (pkg / "kwlex").write_text("".join(f"{w}\t{p}\n"
                                       for w, p in words.items()))
    return str(pkg)
