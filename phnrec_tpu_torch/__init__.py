"""phnrec_tpu_torch — the BUT PhnRec phoneme recognizer on PyTorch and CUDA.

A port of phnrec_tpu (JAX) to one NVIDIA H100.  The numeric pipeline

    waveform -> log mel-filterbank energies -> split-temporal-context (LCRC)
    feature assembly -> band MLPs + merger MLP -> per-frame phoneme-state
    posteriors -> phoneme-loop Viterbi -> time-stamped phoneme labels

runs as torch tensor code on batches of padded utterances, with three
hand-written CUDA kernels (csrc/): the fused MLP, the Viterbi scan and the
device backtrack.  Modules mirror phnrec_tpu's names:

  config.py              typed INI config        (ref configz.{cpp,h}, srec.cpp:34-110)
  io/                    label/weights/audio I/O (ref matrix.h, nn.cpp, traps.cpp)
  frontend/              mel-bank frontend       (ref melbanks.cpp, dspc.cpp)
  posteriors/            LCRC assembly + MLPs    (ref traps.cpp, nn.cpp, fexp.h)
  decoder/               phoneme-loop Viterbi    (ref phndec.cpp)
  ops/, csrc/            CUDA kernels, their builds and plain versions
  parallel/              batch pipeline + loader
  pipeline.py            orchestration           (ref srec.cpp)
  cli.py                 phnrec CLI              (ref phnrec.cpp)
"""

__version__ = "0.1.0"

from phnrec_tpu_torch.config import PhnRecConfig
from phnrec_tpu_torch.pipeline import SpeechRec

__all__ = ["PhnRecConfig", "SpeechRec", "__version__"]
