"""phnrec_tpu_torch — the BUT PhnRec phoneme recognizer on PyTorch and CUDA.

A port of phnrec_tpu (JAX) to one NVIDIA H100.  The numeric pipeline

    waveform -> log mel-filterbank energies -> split-temporal-context (LCRC)
    feature assembly -> band MLPs + merger MLP -> per-frame phoneme-state
    posteriors -> phoneme-loop Viterbi -> time-stamped phoneme labels

runs as torch tensor code on batches of padded utterances, on one stream
fed in chunks (StreamingRecognizer), or on N live streams in lockstep
blocks (MultiStreamRecognizer for the phoneme loop, MultiStreamKWS for
keyword spotting through a dense network Viterbi and the LRTrace
keyword-candidate scan).  Six hand-written CUDA sources (csrc/): the fused
MLP in float32 and in bf16 tensor-core passes (``precision`` selects), the
phoneme-loop Viterbi scan and its ragged form, the device backtrack and
its committed-window form, the network-Viterbi block and the LRTrace scan.
Modules mirror phnrec_tpu's names:

  config.py              typed INI config        (ref configz.{cpp,h}, srec.cpp:34-110)
  io/                    label/weights/audio I/O (ref matrix.h, nn.cpp, traps.cpp),
                         MMF, STK network and Xform parsers, online-norm files
  frontend/              mel-bank frontend       (ref melbanks.cpp, dspc.cpp)
  normalization.py       frame/sentence/online norms (ref srec.cpp, norm.cpp)
  precision.py           MLP precision mode: highest, high, default
  posteriors/            LCRC assembly + MLPs    (ref traps.cpp, nn.cpp, fexp.h)
  decoder/phnloop.py     phoneme-loop Viterbi    (ref phndec.cpp)
  decoder/stknet.py      STK network compile, dense KWS step, LRTrace
                         (ref stkinterface.cpp, STKLib Viterbi.cc)
  fsm.py, lexicon.py,    lexicon, G2P and KWS network generation
  phntrans.py, gptrans.py, (ref fsm.cpp, lexicon.cpp, phntrans.cpp,
  kws.py, netgen.py       gptrans.cpp, kwsnetg.cpp, netgen.cpp)
  ops/, csrc/            CUDA kernels, their builds and plain versions
  parallel/              batch pipeline + loader
  streaming.py           single-stream streaming  (ref srec.cpp:793-927)
  multistream.py         multi-stream serving: phoneme loop and KWS
  pipeline.py            orchestration           (ref srec.cpp)
  cli.py                 phnrec CLI              (ref phnrec.cpp)
"""

__version__ = "0.1.0"

from phnrec_tpu_torch import precision
from phnrec_tpu_torch.config import PhnRecConfig
from phnrec_tpu_torch.multistream import MultiStreamRecognizer
from phnrec_tpu_torch.pipeline import SpeechRec
from phnrec_tpu_torch.streaming import StreamingRecognizer

__all__ = ["MultiStreamRecognizer", "PhnRecConfig", "SpeechRec",
           "StreamingRecognizer", "__version__", "precision"]
