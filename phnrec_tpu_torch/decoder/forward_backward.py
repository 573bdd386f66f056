"""Forward-backward over the phoneme loop (sum semiring), on torch tensors.

Counterpart of phnrec_tpu/decoder/forward_backward.py.  The bundled STK
toolkit carries forward-backward machinery that phnrec itself never calls
(Network::ForwardBackward, STKLib/Viterbi.cc:2115+; PassTokenSum,
Viterbi.cc:603-646); this is its equivalent for the phoneme-loop topology
of decoder/phnloop.py: exact log-domain alpha and beta with logaddexp in
place of the Viterbi max, giving per-frame state occupancies gamma.  Both
scans are kernel J (ops/phnloop_fb.py) on the card, its plain version on
CPU tensors.

Topology: P phonemes x S states, self-loop/advance log-probs, loop
re-entry from every exit state to every entry state with the insertion
penalty added (phndec.cpp:121-144), entry seeded with the penalty at t=0
(the reference quirk, phndec.cpp:81-88).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from phnrec_tpu_torch.decoder.phnloop import PhnLoopSpec
from phnrec_tpu_torch.ops import phnloop_fb


class FBResult(NamedTuple):
    log_alpha: torch.Tensor   # [T, P, S] forward scores
    log_beta: torch.Tensor    # [T, P, S] backward scores
    log_gamma: torch.Tensor   # [T, P, S] normalized occupancies
    log_like: torch.Tensor    # [] total log-likelihood of the loop


def forward_backward(spec: PhnLoopSpec, log_post: torch.Tensor) -> FBResult:
    """[T, >=P*S] log-posteriors (a tensor, on its device) -> exact loop
    occupancies: one launch of kernel J on the card."""
    alpha, beta, like = phnloop_fb.phnloop_fb(
        log_post.to(torch.float32).contiguous()[None], spec.n_phonemes,
        spec.n_states, spec.w_penalty, spec.log_tr_curr, spec.log_tr_next)
    alpha, beta, like = alpha[0], beta[0], like[0]
    return FBResult(log_alpha=alpha, log_beta=beta,
                    log_gamma=alpha + beta - like, log_like=like)


def occupancies(spec: PhnLoopSpec, log_post, per_phoneme: bool = True,
                device: Optional[str] = None) -> np.ndarray:
    """Per-frame posterior state occupancies (linear domain, rows sum to 1)
    on ``device`` (a tensor's own device, else the card).

    per_phoneme=True marginalizes over states -> [T, P]."""
    if not isinstance(log_post, torch.Tensor):
        log_post = torch.as_tensor(np.asarray(log_post, np.float32),
                                   device=device or "cuda")
    elif device is not None:
        log_post = log_post.to(device)
    r = forward_backward(spec, log_post)
    g = np.exp(r.log_gamma.cpu().numpy().astype(np.float64))
    return g.sum(axis=2) if per_phoneme else g
