"""VAD output mode (reference: vadalize.cpp + phndecalize.cpp).

vadalize is phnrec linked against a variant PhnDec whose label writer
emits, for every decoded segment whose phoneme is NOT one of
pau/int/spk, an ALIZE-style line ``start end speech`` with times in
seconds printed %.2f (frame/100, phndecalize.cpp:231-239).  Here it is a
plain post-processing of the decoded labels — same output, no duplicate
decoder.  Copy of phnrec_tpu/vad.py; ``main`` runs the port's CLI.
"""

from __future__ import annotations

from typing import Iterable, List

from phnrec_tpu_torch.io.labels import Label

SILENCE_PHONEMES = ("pau", "int", "spk")


def labels_to_alize(labels: Iterable[Label]) -> List[str]:
    out = []
    for lab in labels:
        if lab.name not in SILENCE_PHONEMES:
            out.append(f"{lab.start_frames / 100:.2f} "
                       f"{lab.end_frames / 100:.2f} speech")
    return out


def write_alize(path: str, labels: Iterable[Label]) -> None:
    with open(path, "w") as f:
        for line in labels_to_alize(labels):
            f.write(line + "\n")


def main(argv=None) -> int:
    """vadalize CLI: same flags as phnrec, ALIZE output."""
    import sys

    from phnrec_tpu_torch import cli

    argv = list(sys.argv[1:] if argv is None else argv)
    return cli.main(argv + ["--alize"]) if "--alize" not in argv \
        else cli.main(argv)


if __name__ == "__main__":
    import sys

    sys.exit(main())
