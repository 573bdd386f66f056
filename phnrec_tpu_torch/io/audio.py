"""Waveform loading and format conversion.

The reference reads input audio as HEADERLESS raw bytes — even `.wav` files
are consumed whole, RIFF header included (srec.cpp:1384-1422).  Two sample
formats (srec.cpp:709-791):

* lin16: little-endian int16, cast to float
* alaw:  one byte/sample, decoded via a 13-bit table and scaled by 8
  (alaw.cpp:14-48, srec.cpp:769)

The float buffer is padded with zeros up to MB_VECTORSIZE=200 samples so even
a too-short signal yields one frame (srec.cpp:731-740; note the reference
uses the compile-time 200 regardless of the configured vector_size).
Then optional DC shift, scaling, and additive uniform noise are applied.

Copy of phnrec_tpu/io/audio.py: the conversion dispatches to the native
host library (phnrec_tpu_torch/native) where it builds, and the NumPy path
is the route it is held equal to.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

MB_VECTORSIZE = 200  # compile-time constant, config.h:20

# A-law -> 13-bit linear table (alaw.cpp:14-48), exact copy of CCITT G.711
# A-law decoding at 5-bit-shifted magnitudes.


def _build_alaw_table() -> np.ndarray:
    """Construct the G.711 A-law decode table (D5 variant: values are the
    13-bit linear codes).  Derivation instead of a verbatim copy: A-law byte
    b -> toggle even bits (XOR 0x55), extract sign/exponent/mantissa, expand.
    Matches alaw.cpp:14-48 exactly."""
    table = np.zeros(256, dtype=np.int16)
    for b in range(256):
        a = b ^ 0x55
        sign = -1 if (a & 0x80) == 0 else 1
        exponent = (a >> 4) & 0x07
        mantissa = a & 0x0F
        if exponent == 0:
            mag = (mantissa << 1) | 1
        else:
            mag = (((mantissa << 1) | 0x21) << (exponent - 1))
        table[b] = sign * mag  # G.711: MSB of (b ^ 0x55) set => positive
    return table


ALAW_TABLE_D5 = _build_alaw_table()


def load_waveform_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def convert_waveform(
    raw: bytes,
    fmt: str = "lin16",
    scale: float = 1.0,
    dc_shift: float = 0.0,
    noise_level: float = 0.0,
    rng: "np.random.Generator | None" = None,
) -> Tuple[np.ndarray, int]:
    """bytes -> (float32 waveform padded to >= 200 samples, true sample count).

    Mirrors SpeechRec::ConvertWaveformFormat (srec.cpp:709-791).

    Dispatches to the native C++ route (native/src/phnrec_native.cpp)
    when it builds; the NumPy path below gives identical results and is
    its oracle in the tests.  The native route is taken only for
    noise_level == 0: the dither RNG streams differ by design (libc rand()
    in the reference, NumPy here, the portable LCG natively).
    """
    if noise_level == 0.0 and fmt in ("lin16", "alaw"):
        from phnrec_tpu_torch import native
        if native.available():
            return native.convert_waveform(raw, fmt, scale, dc_shift)
    if fmt == "lin16":
        sig = np.frombuffer(raw, dtype="<i2", count=len(raw) // 2)
        n = len(sig)
        out = np.zeros(max(n, MB_VECTORSIZE), dtype=np.float32)
        out[:n] = sig.astype(np.float32)
    elif fmt == "alaw":
        codes = np.frombuffer(raw, dtype=np.uint8)
        n = len(codes)
        out = np.zeros(max(n, MB_VECTORSIZE), dtype=np.float32)
        out[:n] = 8.0 * ALAW_TABLE_D5[codes].astype(np.float32)
    else:
        raise ValueError(f"unknown waveform format {fmt!r}")

    if dc_shift != 0.0:
        out += np.float32(dc_shift)
    if scale != 1.0:
        out *= np.float32(scale)
    if noise_level != 0.0:
        gen = rng or np.random.default_rng(0)
        out += np.float32(noise_level) * 2.0 * (
            gen.random(len(out), dtype=np.float32) - 0.5
        )
    return out, n
