"""The yardstick's arithmetic: published peaks of one H100, the work and
roofline bound of a kernel from its shapes, a model's multiply-adds a
frame, and the union of device spans that gives the busy time.

Frozen copy, taken 2026-10-18, of chip_smoke.py's ``PEAK_FP32``,
``PEAK_BF16``, ``PEAK_BYTES``, ``bound``, ``mlp_work`` and the interval
union of ``device_busy_share``; the model's multiply-adds follow the
shapes the configuration file states.  Later changes to chip_smoke.py do
not reach the benchmark.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

# NVIDIA H100 SXM data sheet, dense rates: float32 outside the tensor
# cores, bf16 on them, and the HBM3 rate
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12


def bound_s(n_bytes: float, ops: float, peak_ops: float = PEAK_FP32
            ) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over their type's peak rate."""
    return max(n_bytes / PEAK_BYTES, ops / peak_ops)


def mlp_work(n_rows: int, n_inp: int, n_hid: int, n_out: int,
             passes: int = 0) -> Tuple[int, int]:
    """(bytes, operations) of one 2-layer net over n_rows rows: x read and
    the output written once, the weights read once (float32), two
    operations per multiply-add per pass (passes 0 is float32)."""
    macs = n_rows * (n_inp * n_hid + n_hid * n_out)
    w = n_inp * n_hid + n_hid * n_out
    n_bytes = 4 * (n_rows * (n_inp + n_out) + 2 * n_inp + n_hid + n_out) \
        + 4 * w
    return n_bytes, 2 * macs * max(passes, 1)


def net_shapes(cfg: dict) -> List[Tuple[int, int, int]]:
    """(n_inp, n_hid, n_out) of the LCRC system's three nets: two band
    nets over one context side each, the merger over both outputs.
    Every net has ``n_classes`` classes: the phoneme loop's and, last,
    those it leaves out (the oth class)."""
    n_out = cfg["n_classes"] * cfg["n_states"]
    band_in = cfg["nbanks"] * cfg["n_coefs"]
    return [(band_in, cfg["band_hidden"], n_out)] * 2 + \
        [(2 * n_out, cfg["merger_hidden"], n_out)]


def nets_macs_per_frame(cfg: dict) -> int:
    """Multiply-adds of the three nets for one frame."""
    return sum(i * h + h * o for i, h, o in net_shapes(cfg))


def model_macs_per_frame(cfg: dict) -> int:
    """Multiply-adds a valid frame costs in the model: the three nets,
    the frontend's DFT product (vector_size x nfft: real and imaginary
    halves) and its mel product (nfft/2 x nbanks), and the LCRC taps (two
    sides, nbanks x half context x coefficients)."""
    nfft = 1
    while nfft < cfg["vector_size"]:
        nfft *= 2
    half = (cfg["trap_len"] - 1) // 2 + 1
    frontend = cfg["vector_size"] * nfft + nfft // 2 * cfg["nbanks"]
    lcrc = 2 * cfg["nbanks"] * half * cfg["n_coefs"]
    return nets_macs_per_frame(cfg) + frontend + lcrc


def union_s(spans: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    spans = sorted(s for s in spans if s[1] > s[0])
    if not spans:
        return 0.0
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    return busy + cur_e - cur_s


def gaps(spans: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The (start, end) gaps between the union's intervals."""
    spans = sorted(s for s in spans if s[1] > s[0])
    out: List[Tuple[float, float]] = []
    if not spans:
        return out
    cur_e = spans[0][1]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            out.append((cur_e, s0))
        cur_e = max(cur_e, e0)
    return out
