"""Batch decoding: a list of waveforms -> .rec label files.

Twin of examples/batch_decode.py on the port: the utterances are padded
into one [B, L] batch and the whole wav->labels path runs through
BatchPipeline (kernels A or A', C and D on the card).

    python -m phnrec_tpu_torch.examples.batch_decode [--device DEV] PKG_DIR out_dir wav1 [wav2 ...]
"""

import os
import sys

from phnrec_tpu_torch.examples import split_device
from phnrec_tpu_torch.io import audio
from phnrec_tpu_torch.io.labels import write_rec
from phnrec_tpu_torch.parallel.batch import BatchPipeline
from phnrec_tpu_torch.pipeline import SpeechRec


def main(argv=None) -> int:
    device, args = split_device(argv)
    if len(args) < 3:
        print(__doc__)
        return 1
    pkg, out_dir, *wavs = args
    os.makedirs(out_dir, exist_ok=True)

    sr = SpeechRec(pkg, device=device)
    bp = BatchPipeline(sr)
    waves = [audio.convert_waveform(audio.load_waveform_bytes(w),
                                    sr.wave_format)[0] for w in wavs]
    result = bp.run(waves)
    for path, labels in zip(wavs, result.labels):
        tgt = os.path.join(
            out_dir, os.path.splitext(os.path.basename(path))[0] + ".rec")
        write_rec(tgt, labels)
        print(f"{path} -> {tgt} ({len(labels)} segments)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
