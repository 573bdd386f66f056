"""Frame- and sentence-normalization on torch tensors.

Counterpart of phnrec_tpu/normalization.py:1-101.  Reference:
SpeechRec::FrameBasedNormalization (srec.cpp:1594-1620) and
SpeechRec::SentenceBasedNormalization (srec.cpp:1492-1592).  The online
estimator (``OnlineNorm``) belongs to streaming and is not ported yet.

The sentence statistics take an optional valid-frame count so padded
utterances normalize over real frames only (padded rows replicate the last
frame, which WOULD bias the mean).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

FRAME_NORM_NO_FLOOR = -9999.9  # framenorm/min_floor default (srec.cpp:68)


class SentenceNormSpec(NamedTuple):
    mean_norm: bool = False
    var_norm: bool = False
    std_thr: float = 0.01
    max_norm: bool = False
    chmax_norm: bool = False

    @property
    def enabled(self) -> bool:
        return (self.mean_norm or self.var_norm or self.max_norm
                or self.chmax_norm)


def spec_from_config(cfg) -> SentenceNormSpec:
    # the registered offlinenorm/sent_std_thr (srec.cpp:64), as in
    # phnrec_tpu/normalization.py: the reference's melbanks/sent_std_thr
    # read (srec.cpp:1531) names a variable that was never registered
    return SentenceNormSpec(
        mean_norm=cfg.get_bool("offlinenorm", "sent_mean_norm"),
        var_norm=cfg.get_bool("offlinenorm", "sent_var_norm"),
        std_thr=cfg.get_float("offlinenorm", "sent_std_thr"),
        max_norm=cfg.get_bool("offlinenorm", "sent_max_norm"),
        chmax_norm=cfg.get_bool("offlinenorm", "sent_chmax_norm"),
    )


def frame_norm(x: torch.Tensor, shift: float = 0.0,
               min_floor: float = FRAME_NORM_NO_FLOOR) -> torch.Tensor:
    if shift != 0.0:
        x = x + shift
    if min_floor != FRAME_NORM_NO_FLOOR:
        x = torch.clamp(x, min=min_floor)
    return x


def sentence_norm(x: torch.Tensor, spec: SentenceNormSpec,
                  n_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sentence mean/variance/maximum normalization (srec.cpp:1492-1592).

    ``x`` is [..., T, D]; ``n_valid`` (shape ``x.shape[:-2]``) counts the
    real rows of each utterance.  Statistics cover the first n_valid rows;
    padded rows are normalized too, harmlessly, since they are dropped.
    """
    if not spec.enabled:
        return x
    T = x.shape[-2]
    if n_valid is None:
        inv_n = 1.0 / T
        mask = None
    else:
        n = n_valid.to(torch.float32)[..., None, None]
        inv_n = 1.0 / n
        t = torch.arange(T, device=x.device)
        mask = (t < n_valid.to(x.device)[..., None])[..., None]

    def _sum(v):
        v = torch.where(mask, v, 0.0) if mask is not None else v
        return torch.sum(v, dim=-2, keepdim=True)

    if spec.mean_norm or spec.var_norm:
        mean = _sum(x) * inv_n
        x = x - mean
        if spec.var_norm:
            std = torch.sqrt(_sum(x * x) * inv_n)
            std = torch.clamp(std, min=spec.std_thr)
            x = x * (1.0 / std)
            if not spec.mean_norm:
                x = x + mean

    if spec.max_norm or spec.chmax_norm:
        xm = torch.where(mask, x, -9999.9) if mask is not None else x
        chmax = torch.amax(xm, dim=-2, keepdim=True)
        if spec.max_norm:
            # the true global maximum, as phnrec_tpu/normalization.py
            # implements the reference's evident intent (srec.cpp:1571-1582)
            x = x - torch.amax(chmax, dim=-1, keepdim=True)
        else:
            x = x - chmax
    return x
