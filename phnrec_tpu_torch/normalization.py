"""Frame- and sentence-normalization on torch tensors.

Counterpart of phnrec_tpu/normalization.py.  Reference:
SpeechRec::FrameBasedNormalization (srec.cpp:1594-1620),
SpeechRec::SentenceBasedNormalization (srec.cpp:1492-1592) and the online
estimator of norm.{cpp,h}: ``OnlineNorm`` is a copy of
phnrec_tpu/normalization.py:104-212 (host numpy); its device-carried form
lives in the multi-stream server (multistream.py, ``_onorm``).

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


class OnlineNorm:
    """Streaming per-channel mean/variance normalization (norm.{cpp,h}).

    Accumulates the first ``estim_interval`` frames, then freezes
    mean/inv-std and applies them to every frame from the one completing
    the estimate onward (earlier frames pass through with the identity
    params, norm.cpp:216-234).  Parameters persist to an XML file
    auto-loaded on startup (only effective when estim_interval == 0,
    because a nonzero interval re-estimates and overwrites — reference
    init order srec.cpp:594-601).  Channels switch via set_channel
    (multi-channel audio sources).
    """

    def __init__(self, dim: int, estim_interval: int = 0,
                 mean_norm: bool = False, var_norm: bool = False,
                 scale_to_gvar: bool = False, file: str = "none"):
        import os

        self.dim = dim
        self.estim_interval = estim_interval
        self.mean_norm = mean_norm
        self.var_norm = var_norm
        self.scale_to_gvar = scale_to_gvar
        self.file = file
        self.channels: dict = {}
        self.cur = 0
        if file not in ("", "none") and os.path.exists(file):
            from phnrec_tpu_torch.io.normfile import load_norm_file
            for cid, ch in load_norm_file(file).items():
                st = self._state(cid)
                st["mean"] = ch.get("mean", st["mean"])
                st["inv_std"] = ch.get("inv_std", st["inv_std"])
                st["glob_std"] = ch.get("glob_std", st["glob_std"])

    @property
    def enabled(self) -> bool:
        return self.mean_norm or self.var_norm

    def _state(self, cid: int) -> dict:
        import numpy as np
        if cid not in self.channels:
            self.channels[cid] = dict(
                n=0,
                x=np.zeros(self.dim, np.float32),
                x2=np.zeros(self.dim, np.float32),
                mean=np.zeros(self.dim, np.float32),
                inv_std=np.ones(self.dim, np.float32),
                glob_std=np.ones(self.dim, np.float32),
                frozen=self.estim_interval == 0,
            )
        return self.channels[cid]

    def set_channel(self, cid: int) -> None:
        self.cur = cid
        self._state(cid)

    def _save(self) -> None:
        if self.file in ("", "none"):
            return
        from phnrec_tpu_torch.io.normfile import save_norm_file
        save_norm_file(self.file, {
            cid: (st["mean"], st["inv_std"])
            for cid, st in self.channels.items()
        })

    def process_block(self, frames):
        """[F, dim] numpy block -> normalized block (in frame order,
        replicating the per-frame Accum/Update/Norm sequencing)."""
        import numpy as np
        st = self._state(self.cur)
        out = np.array(frames, dtype=np.float32, copy=True)
        i = 0
        F = out.shape[0]
        while not st["frozen"] and i < F and st["n"] < self.estim_interval:
            take = min(self.estim_interval - st["n"], F - i)
            blk = out[i : i + take]
            st["x"] += blk.sum(axis=0)
            st["x2"] += (blk * blk).sum(axis=0)
            st["n"] += take
            if st["n"] == self.estim_interval:
                st["mean"] = st["x"] / st["n"]
                var = st["x2"] / st["n"] - st["mean"] * st["mean"]
                st["inv_std"] = (1.0 / np.sqrt(var)).astype(np.float32)
                st["frozen"] = True
                self._save()
                # the frame completing the estimate IS normalized
                i += take - 1
            else:
                i += take  # still estimating: identity applied
        if st["frozen"] or self.estim_interval == 0:
            sl = slice(i, F)
            if self.mean_norm:
                out[sl] -= st["mean"]
            if self.var_norm:
                out[sl] *= st["inv_std"]
                if self.scale_to_gvar:
                    out[sl] *= st["glob_std"]
        return out

    @classmethod
    def from_config(cls, cfg, dim: int) -> "OnlineNorm":
        return cls(
            dim=dim,
            estim_interval=cfg.get_int("onlinenorm", "estim_interval"),
            mean_norm=cfg.get_bool("onlinenorm", "mean_norm"),
            var_norm=cfg.get_bool("onlinenorm", "var_norm"),
            scale_to_gvar=cfg.get_bool("onlinenorm", "scale_to_gvar"),
            file=cfg.get_str("onlinenorm", "file"),
        )
