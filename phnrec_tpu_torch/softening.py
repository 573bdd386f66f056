"""Posterior "softening" functions (srec.cpp:163-177, srec.h:192-195).

Counterpart of phnrec_tpu/softening.py on torch tensors.  Config syntax:
``softening_func=<name> <a1> <a2> <a3>`` (srec.cpp:1331-1363).  Two slots
exist: posteriors/softening_func (applied when posteriors leave the
estimator) and decoder/softening_func (applied before decoding); the
shipped packages use ``none`` + ``log``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class SofteningSpec(NamedTuple):
    name: str
    a1: float = 0.0
    a2: float = 0.0
    a3: float = 0.0


def parse_softening(value: str) -> SofteningSpec:
    parts = value.split()
    if len(parts) != 4:
        raise ValueError(
            f"invalid softening function format {value!r}: expected "
            "'name a1 a2 a3'")
    name = parts[0]
    if name not in ("none", "log", "igor", "gmm_bypass"):
        raise ValueError(f"unknown softening function {name!r}")
    return SofteningSpec(name, *(float(p) for p in parts[1:]))


def softening_fn(spec: SofteningSpec) -> Callable[[torch.Tensor], torch.Tensor]:
    if spec.name == "none":
        return lambda v: v
    if spec.name == "log":
        return torch.log
    if spec.name == "igor":
        midd, right_log, left_log = spec.a1, spec.a2, spec.a3
        ln_left = float(torch.log(torch.tensor(left_log, dtype=torch.float32)))
        ln_right = float(torch.log(torch.tensor(right_log,
                                                dtype=torch.float32)))

        def igor(v):
            lo = torch.log(v * (1.0 / midd)) / ln_left
            hi = -torch.log((1.0 - v) * (1.0 / (1.0 - midd))) / ln_right
            return torch.where(v < midd, lo, hi)

        return igor
    if spec.name == "gmm_bypass":
        return lambda v: torch.sqrt(-2.0 * torch.log(v))
    raise ValueError(spec.name)

