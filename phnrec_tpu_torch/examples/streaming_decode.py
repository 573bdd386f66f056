"""Streaming decode: feed audio in chunks, get phonemes with a fixed lag.

Twin of examples/streaming_decode.py on the port: StreamingRecognizer
(kernels A or A' and C on the card; the labels are walked on the host
over the History copied back) prints the settled labels as each chunk
arrives, then the final labels, which equal the offline decode on
packages without sentence normalization.

    python -m phnrec_tpu_torch.examples.streaming_decode [--device DEV] PKG_DIR audio.raw [chunk_ms]
"""

import sys

from phnrec_tpu_torch.examples import split_device
from phnrec_tpu_torch.pipeline import SpeechRec
from phnrec_tpu_torch.streaming import StreamingRecognizer


def main(argv=None) -> int:
    device, args = split_device(argv)
    if len(args) < 2:
        print(__doc__)
        return 1
    pkg, path = args[0], args[1]
    chunk_ms = int(args[2]) if len(args) > 2 else 250

    sr = SpeechRec(pkg, device=device)
    rate = sr.cfg.get_int("source", "sample_freq")
    bps = 2 if sr.wave_format == "lin16" else 1
    chunk = rate * chunk_ms // 1000 * bps

    rec = StreamingRecognizer(sr)
    emitted = 0
    with open(path, "rb") as f:
        while True:
            data = f.read(chunk)
            if not data:
                break
            rec.process(data)
            settled = rec.results(settled_only=True)
            for lab in settled[emitted:]:
                print(f"  [settled] {lab.name:6s} "
                      f"{lab.start_frames * 10:6d}..{lab.end_frames * 10}ms")
            emitted = len(settled)
    final = rec.finish()
    print(f"final: {' '.join(l.name for l in final)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
