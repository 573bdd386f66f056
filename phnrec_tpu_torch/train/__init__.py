"""HMM training / re-estimation on torch tensors.

Counterpart of phnrec_tpu/train: the equivalent of the bundled STK
toolkit's training machinery that phnrec itself never calls (exact
forward-backward, Network::ForwardBackward, STKLib/Viterbi.cc:2115+;
Baum-Welch / Viterbi / MCE re-estimation, Viterbi.h:253-259,
Viterbi.cc:1124-1240; per-mixture/transition accumulators and the ML / MMI
extended-Baum-Welch updates, ModelSet::UpdateFromAccums, Models.h:473,541).

An utterance's transcription compiles into a dense linear composite HMM
(train.graph), forward-backward and Viterbi alignment run over a bucket of
utterances as kernels K and K' (train.fb, ops/trainfb.py), statistics land
in fixed-shape accumulator tensors (train.accum), and parameter updates
are host functions over those accumulators (train.update).  The all-reduce
of accumulators over a mesh's "data" group is psum_accumulators
(torch.distributed, parallel/mesh.py).
"""

from phnrec_tpu_torch.train.graph import TrainGraph, compile_transcription
from phnrec_tpu_torch.train.fb import forward_backward, viterbi_align
from phnrec_tpu_torch.train.accum import Accumulators, make_accumulators, \
    accumulate_utterance, merge_accumulators, psum_accumulators, \
    save_accumulators, load_accumulators
from phnrec_tpu_torch.train.mbr import accumulate_utterance_mbr, \
    reference_hmm_ids
from phnrec_tpu_torch.train.update import update_ml, update_mmi, \
    mce_weight, apply_update

__all__ = [
    "TrainGraph", "compile_transcription",
    "forward_backward", "viterbi_align",
    "Accumulators", "make_accumulators", "accumulate_utterance",
    "merge_accumulators", "psum_accumulators", "save_accumulators",
    "load_accumulators",
    "accumulate_utterance_mbr", "reference_hmm_ids",
    "update_ml", "update_mmi", "mce_weight", "apply_update",
]
