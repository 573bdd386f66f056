"""Time the ten kernels of chip_smoke.py's kernels line by two timers in
one process, to see which times the host's rate of launches sets.

    python3 -m phnrec_tpu_torch.devtools.timer_check    # from the repo root

The timers: mlp_variants.cuda_ms (chip_smoke.py's: CUDA events around the
calls) and scan_variants.held_ms (the same with the card held by a spin
kernel while the host enqueues the calls, so a kernel shorter than its
wrapper's host work is timed).  Runs chip_smoke.py's checks of kernels A
and A' (CZ shapes), C and D, C' and D', B and F (EN shapes) and its timing
of G and H (the CZ stkint loop, B 256 x T 500) once with each timer, in
that order, and prints one JSON line per timer with each kernel's ms at
chip_smoke.py's shapes, then the card's name and power limit.  The
checks' own phase lines go before them.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import torch

from phnrec_tpu_torch import precision, synth
from phnrec_tpu_torch.decoder.stknet import OFF_BEAM, DenseKWSScan
from phnrec_tpu_torch.devtools.mlp_variants import cuda_ms
from phnrec_tpu_torch.devtools.scan_variants import held_ms
from phnrec_tpu_torch.pipeline import SpeechRec


def main() -> int:
    if not torch.cuda.is_available():
        print("ERROR: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    dev = torch.device("cuda", 0)
    cs.build_all()
    precision.set_mode("highest")
    with tempfile.TemporaryDirectory() as tmp:
        cz = SpeechRec(synth.write_lcrc_package(
            os.path.join(tmp, "cz"), "cz", seed=0), device=dev)
        en = SpeechRec(synth.write_kws_package(
            os.path.join(tmp, "en"), "en", seed=0), device=dev)
        dense = DenseKWSScan(en.stk_decoder.decoder)
        stk = SpeechRec(synth.write_stk_decode_package(
            os.path.join(tmp, "cz_stk"), "cz", seed=0), device=dev)
        for name, timer in (("ms", cuda_ms), ("held_ms", held_ms)):
            cs.cuda_ms = timer
            out = {"mlp_fused": cs.check_mlp(cz, dev)}
            a_ms = out["mlp_fused"].pop("per_net")
            out["mlp_bf16x3"] = cs.check_mlp_bf16x3(cz, dev, a_ms)
            out["phnloop_viterbi"], out["backtrack"] = \
                cs.check_viterbi_backtrack(dev)
            out["phnloop_viterbi_ragged"], out["backtrack_committed"] = \
                cs.check_ragged_committed(dev)
            b_out = cs.check_netstep(dense, dev)
            out["netstep"] = b_out[float(OFF_BEAM)]
            out["lrtrace"] = cs.check_lrtrace(en.stk_decoder.compiled,
                                              b_out[float(OFF_BEAM)], dev)
            out.update(cs.time_netscan(stk.stk_decoder.decoder, dev))
            print(json.dumps({"timer": name, **{
                k: {"ms": v["ms"], "plain_ms": v["plain_ms"]}
                for k, v in out.items()}}), flush=True)
    print(cs.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
