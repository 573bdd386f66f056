"""Keyword spotting: build a KWS network for a keyword list and score an
utterance by keyword/filler likelihood ratio.

Twin of examples/keyword_spotting.py on the port: the reference's KWS
mode (stkinterface.cpp:240-289), a background phoneme loop (filler) in
parallel with one branch a keyword pronunciation, decoded by
StkNetworkDecoder (kernel G on the card) over the package's posteriors
(kernel A or A').

    python -m phnrec_tpu_torch.examples.keyword_spotting [--device DEV] PKG_DIR audio.raw "kw1=p h n" [...]

Keywords are `name=phone phone ...`, phones from the package's phoneme
list (the file its config's [dicts] phoneme_list names; dicts/phonemes
in BUT's packages).
"""

import os
import sys
import tempfile

import numpy as np

from phnrec_tpu_torch import netgen
from phnrec_tpu_torch.decoder.stknet import StkNetworkDecoder
from phnrec_tpu_torch.examples import split_device
from phnrec_tpu_torch.io import audio
from phnrec_tpu_torch.io.mmf import parse_mmf
from phnrec_tpu_torch.io.stknet import parse_stk_network
from phnrec_tpu_torch.kws import KWSNetGenerator
from phnrec_tpu_torch.lexicon import Lexicon
from phnrec_tpu_torch.phntrans import PhnTranscriber
from phnrec_tpu_torch.pipeline import SpeechRec


def main(argv=None) -> int:
    device, args = split_device(argv)
    if len(args) < 3:
        print(__doc__)
        return 1
    pkg, path = args[0], args[1]
    keywords = {}
    for a in args[2:]:
        name, pron = a.split("=", 1)
        keywords[name] = pron.strip()

    sr = SpeechRec(pkg, device=device)
    phn_list = sr.cfg.get_str("dicts", "phoneme_list")

    lex = Lexicon()
    for w, pron in keywords.items():
        lex.add_word(w, pron)
    gen = KWSNetGenerator(PhnTranscriber(lexicon=lex, mode="lexicon"))
    gen.load_phn_list(phn_list)

    with tempfile.TemporaryDirectory() as d:
        mmf_path = os.path.join(d, "models")
        net_path = os.path.join(d, "kwsnet")
        netgen.phn_list_to_hmm_defs(phn_list, mmf_path, 3)
        gen.generate(sorted(keywords), net_path)
        ms = parse_mmf(mmf_path)
        net = parse_stk_network(net_path)
    dec = StkNetworkDecoder(ms, net, wpenalty=sr.loop_spec.w_penalty,
                            lm_scale=1.0, mode="kws", device=sr.device)

    post = sr.process_offline("wf", "post",
                              audio.load_waveform_bytes(path))
    hits = dec.decode(np.log(np.maximum(np.asarray(post), 1e-37)))
    if not hits:
        print("no keyword candidates")
    for h in hits:
        print(f"{h.name:12s} {h.start_frames * 10:6d}.."
              f"{h.end_frames * 10}ms  LR={h.score:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
