"""Chunked (streaming) recognition helpers shared by the multi-stream
server.

Counterpart of phnrec_tpu/streaming.py:584-645: ``_convert_chunk`` (a
chunk-safe waveform conversion on the host) and the LCRC form of
``_make_posterior_block_fn`` (per-stream context windows -> decoder-ready
log-posteriors), here batched over streams instead of vmapped.  The
single-stream ``StreamingRecognizer`` is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from phnrec_tpu_torch.io import audio
from phnrec_tpu_torch.posteriors.estimator import sln


def _convert_chunk(raw: bytes, sr) -> np.ndarray:
    """Chunk-safe waveform conversion (no 200-sample min padding — that is
    a whole-file concern handled by io.audio.convert_waveform)."""
    if sr.wave_format == "lin16":
        wave = np.frombuffer(raw, dtype="<i2").astype(np.float32)
    else:
        wave = 8.0 * audio.ALAW_TABLE_D5[
            np.frombuffer(raw, dtype=np.uint8)].astype(np.float32)
    if sr.wave_dc_shift != 0.0:
        wave = wave + np.float32(sr.wave_dc_shift)
    if sr.wave_scale != 1.0:
        wave = wave * np.float32(sr.wave_scale)
    return wave


def _make_posterior_block_fn(sr):
    """[N, 2s+F, nbanks] per-stream context -> [N, F, n_out] log-posteriors:
    the 31-frame windows gathered per frame, each side's taps applied as
    one contraction, then the band and merger nets (kernel A) and both
    softenings."""
    est = sr.estimator
    if not hasattr(est, "assembler"):
        raise NotImplementedError(
            "streaming needs the LCRC estimator; the 3BT/1BT/1BT_DCT "
            "systems are not ported yet (ROADMAP.md, Queue 1 item 11)")
    asm = est.assembler
    hc = asm.half_context
    width = 2 * est.trap_shift + 1

    def run(ctx: torch.Tensor) -> torch.Tensor:
        N, T, _ = ctx.shape
        F = T - 2 * est.trap_shift
        idx = (torch.arange(F, device=ctx.device)[:, None]
               + torch.arange(width, device=ctx.device)[None, :])
        win = ctx[:, idx]                              # [N, F, 31, nb]
        left = torch.einsum("ntjb,jc->ntbc", win[:, :, :hc], asm.m_left)
        right = torch.einsum("ntjb,jc->ntbc", win[:, :, hc - 1:],
                             asm.m_right)
        lo = est.band[0](left.reshape(N, F, -1), est.fast_exp)
        ro = est.band[1](right.reshape(N, F, -1), est.fast_exp)
        post = est.merger(sln(torch.cat([lo, ro], dim=-1)), est.fast_exp)
        return sr.dec_soft(sr.post_soft(post))

    return run


class StreamingRecognizer:
    """Single-stream chunked recognition: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "StreamingRecognizer is not ported yet (ROADMAP.md, Queue 1 "
            "item 7: streaming and phnloop serving); multi-stream KWS "
            "serving is phnrec_tpu_torch.multistream.MultiStreamKWS")
