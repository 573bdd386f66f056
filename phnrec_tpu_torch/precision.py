"""Precision knob of the three MLPs of the posterior estimator.

Counterpart of phnrec_tpu/precision.py.  The reference computes in CPU
float32 (STK FLOAT, STKLib/common.h:92-103).  The mode selects which kernel
runs the band and merger MLPs (posteriors/mlp.py), read at each call:

  * ``"highest"`` (default): kernel A (ops/mlp_fused.py), float32 FMAs;
  * ``"high"``: kernel A' (ops/mlp_bf16x3.py), each float32 product taken
    as three bf16 tensor-core passes, a_hi*b_hi + a_hi*b_lo + a_lo*b_hi,
    summed in float32 (phnrec_tpu's Precision.HIGH kernel ``_kernel3``);
  * ``"default"``: kernel A' with one pass, a_hi*b_hi (what the TPU's
    matrix unit does at Precision.DEFAULT).

Only the MLPs follow the mode.  The frontend GEMMs, the LCRC taps and the
transforms stay float32 with TF32 off in every mode: that is what
phnrec_tpu computes on the CPU, where the tests hold the port, and a
deliberate difference from the TPU, where those GEMMs follow the mode too.
They are a small share of the device time (PERF.md).

Set it in code, or with the PHNREC_TPU_PRECISION environment variable,
read when this module is imported:

    from phnrec_tpu_torch import precision
    precision.set_mode("high")
"""

from __future__ import annotations

import os

MODES = ("highest", "high", "default")

_mode = os.environ.get("PHNREC_TPU_PRECISION", "highest").lower()
if _mode not in MODES:
    _mode = "highest"


def set_mode(mode: str) -> None:
    global _mode
    if mode not in MODES:
        raise ValueError(f"precision mode must be one of {sorted(MODES)}")
    _mode = mode


def get_mode() -> str:
    return _mode


def mlp_passes() -> int:
    """bf16 passes of kernel A' in the current mode; 0 means kernel A."""
    return {"highest": 0, "high": 3, "default": 1}[_mode]
