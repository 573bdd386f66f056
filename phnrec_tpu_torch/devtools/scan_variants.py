"""Compare variants of the scan kernels' sources on one CUDA card: kernel F
(the LRTrace scan, csrc/lrtrace.cu) or kernels C and C' (the phoneme-loop
scan, csrc/phnloop_viterbi.cu).

    python3 -m phnrec_tpu_torch.devtools.scan_variants [--ablate] \\
        REF.cu [VARIANT.cu ...] [-- VARIANT.cu ...]

The entry point follows the first source's exported symbol: ``lrtrace_scan``
(kernel F) or ``phn_viterbi`` (kernels C and C').  Builds every source given
(all at once, with the package's nvcc flags, into
build/phnrec_tpu_torch/variants/) and prints each build's registers and
spills.  With ``--ablate`` each source before a ``--`` is also built once
for each of the ABLATIONS below whose text it holds, with that part cut
out, to see what its frame is made of; those copies compute wrong
results: they are timed, not checked.  The parent's source is extracted
by the caller, e.g.
``git show HEAD~1:phnrec_tpu_torch/csrc/lrtrace.cu > build/lrtrace_ref.cu``;
a kernel-C source older than the row limit (no ``phn_viterbi_max_row``)
is taken to accept rows of any width.

Every build that is not an ablation is held to the plain version
(ops/lrtrace.py::lrtrace_scan_plain, every field bit-equal;
ops/phnloop_viterbi.py::viterbi_block_plain and
viterbi_block_ragged_plain, carry and valid History bit-equal) on the case
lists LRTRACE_CASES and VITERBI_CASES, which chip_smoke.py holds the
package's kernels to as well: tie-heavy small-integer inputs (with -0.0
among the phoneme-loop observations); every template instance of the
package's sources (kernel F: 1-4 keywords a lane, time pruning on and
off, whole-row and column copies; kernels C and C': 1-5 states by 1-4
phonemes a lane); one stream or utterance, counts that fill no warp, a
single frame, block lengths that fill no chunk, every row dead, and two
blocks chained through the state.
Then it times all builds in turns (first to last, then last to first) at
the serving shapes: kernel F at n 256 x F 512 x K 2 (the EN net's sinks,
time pruning 40), kernel C' at B 256 x T 512 (chip_smoke.py's ragged
case) and kernel C at B 256 x T 500, each by two timers: ``ms`` by
mlp_variants.cuda_ms (chip_smoke.py's), and ``held_ms`` by held_ms below,
which holds the card while the host enqueues the calls.  It reads the SM
clock under load to give clocks a frame of each.  One JSON line per build,
check and timing.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from phnrec_tpu_torch.decoder import phnloop
from phnrec_tpu_torch.decoder.stknet import NEG, lrtrace_init_state
from phnrec_tpu_torch.devtools.mlp_variants import build, cuda_ms
from phnrec_tpu_torch.devtools.netstep_variants import sm_clock
from phnrec_tpu_torch.ops import _build, lrtrace, phnloop_viterbi

# text edits that cut one part out of a source: (what, [(old, new), ...]),
# applied to each source that holds every `old`
ABLATIONS = (
    # the first kernel F: every frame loads frame 0's inputs
    ("loads_frame0", [("const size_t row = ((size_t)f * n + b) * S;",
                       "const size_t row = (size_t)b * S;")]),
    # kernel F: no event record is stored (the first kernel, the staged)
    ("no_records", [("if (has[i]) {", "if (false) {")]),
    ("no_records", [("if (has[i])\n          r[",
                     "if (false)\n          r[")]),
    # the staged kernel F: every frame reads its chunk's first frame
    ("smem_frame0", [("const int fo = (fr + 1 < nf ? fr + 1 : fr) * W;",
                      "const int fo = 0;")]),
    # the staged kernel F: keyword 0's candidate end not shuffled
    ("no_end0_shuffle", [("__shfl_sync(0xffffffffu, n_ce[0], 0)",
                          "n_ce[0]")]),
    # the first kernel C: every frame's observations are frame 0's
    ("obs_frame0", [("const float* row = up + (size_t)(t + 1) * D;",
                     "const float* row = up;")]),
    # the first kernel C: no shuffle butterfly (lane 0's own best wins)
    ("no_butterfly", [("for (int off = 16; off > 0; off >>= 1) {",
                       "for (int off = 16; off > 16; off >>= 1) {")]),
    # the staged kernel C: every frame's observations are its chunk's first
    ("obs_chunk0", [("const float* row = ob + min(tt + 1, nf - 1) * D;",
                     "const float* row = ob;")]),
    # the staged kernel C: no warp max (each lane's own best) ...
    ("no_warp_max", [("return __reduce_max_sync(0xffffffffu, key);",
                      "return key;")]),
    # ... and no ballot either (each lane its own winner)
    ("no_warp_argmax", [("return __reduce_max_sync(0xffffffffu, key);",
                         "return key;"),
                        ("const int wl = __ffs(m) - 1;",
                         "const int wl = lane;")]),
)

# kernel F: name -> (n, F, K, S, dict(seed, ties, dead)); S >= K + 1.  K 1,
# 2 and 13 run 1 keyword a lane, 33 2, 70 3, 96 and 128 4; S 4 and 16 take
# the whole-row copies, the other S the column copies.
LRTRACE_CASES = {
    "main": (256, 512, 2, 4, dict(seed=61)),
    "ties": (256, 512, 2, 4, dict(seed=62, ties=True)),
    "K1_n13": (13, 77, 1, 4, dict(seed=63)),
    "K1_ties": (13, 77, 1, 4, dict(seed=64, ties=True)),
    "K13_S16": (13, 77, 13, 16, dict(seed=65, ties=True)),
    "K33": (13, 77, 33, 34, dict(seed=66, ties=True)),
    "K33_walk": (13, 77, 33, 34, dict(seed=67)),
    "K70": (13, 77, 70, 71, dict(seed=75, ties=True)),
    "K70_walk": (13, 77, 70, 71, dict(seed=76)),
    "K96": (13, 77, 96, 97, dict(seed=77, ties=True)),
    "K128": (13, 77, 128, 129, dict(seed=68, ties=True)),
    "K128_n1": (1, 100, 128, 132, dict(seed=69)),
    "n1_F1": (1, 1, 2, 4, dict(seed=70)),
    "F1": (256, 1, 2, 4, dict(seed=71)),
    "all_dead": (256, 64, 2, 4, dict(seed=72, dead=True)),
}
# past one launch's 128 keywords (groups of 128): K 129 and 200, each
# with tie-heavy and random-walk records
LRTRACE_WIDE_CASES = {
    "K129": (13, 77, 129, 131, dict(seed=105, ties=True)),
    "K129_walk": (13, 77, 129, 130, dict(seed=106)),
    "K200": (13, 77, 200, 203, dict(seed=107, ties=True)),
    "K200_walk_n1": (1, 100, 200, 201, dict(seed=108)),
}
LRTRACE_PRUNING = (40, 1e10)          # time pruning on and off
LRTRACE_SCORE = {False: -1e30, True: -3.0}   # score pruning by `ties`

# kernels C and C': name -> (P, S, B, T, D, dict(seed, ties)); ties
# "ints" are small-integer observations with the CZ loop's constants,
# "zeros" mostly +0.0 and -0.0 observations with zero penalties (-0.0,
# +0.0 and -0.0), so exits of -0.0 and +0.0 tie.  T 37 fills no
# 16-frame chunk.  Every S of 1-5 runs with P of each phonemes-a-lane
# count: up to 32, 64, 96 and 128.
VITERBI_CASES = {
    "P7_S1": (7, 1, 13, 37, 7, dict(seed=81, ties="zeros")),
    "P20_S2": (20, 2, 13, 37, 41, dict(seed=91, ties="ints")),
    "P32_S3": (32, 3, 13, 37, 96, dict(seed=82)),
    "P31_S4": (31, 4, 13, 37, 126, dict(seed=92, ties="zeros")),
    "P9_S5": (9, 5, 13, 37, 45, dict(seed=93, ties="ints")),
    "P50_S1": (50, 1, 13, 37, 53, dict(seed=94, ties="ints")),
    "P40_S2": (40, 2, 13, 37, 80, dict(seed=95)),
    "P46_S3_D141": (46, 3, 13, 37, 141, dict(seed=84, ties="ints")),
    "P64_S3": (64, 3, 1, 37, 192, dict(seed=85, ties="zeros")),
    "P63_S4": (63, 4, 13, 37, 254, dict(seed=96, ties="zeros")),
    "P33_S5": (33, 5, 13, 37, 165, dict(seed=83, ties="ints")),
    "P96_S1": (96, 1, 13, 37, 99, dict(seed=97, ties="zeros")),
    "P80_S2": (80, 2, 13, 37, 160, dict(seed=98, ties="ints")),
    "P65_S3": (65, 3, 13, 37, 195, dict(seed=99)),
    "P80_S4": (80, 4, 13, 37, 322, dict(seed=100, ties="ints")),
    "P70_S5": (70, 5, 1, 37, 350, dict(seed=101, ties="zeros")),
    "P128_S1": (128, 1, 13, 37, 128, dict(seed=87, ties="zeros")),
    "P100_S2": (100, 2, 13, 37, 203, dict(seed=102, ties="zeros")),
    "P97_S3": (97, 3, 13, 37, 291, dict(seed=103, ties="ints")),
    "P120_S4": (120, 4, 13, 37, 480, dict(seed=104)),
    "P128_S5": (128, 5, 13, 37, 640, dict(seed=86, ties="ints")),
    "T1": (46, 3, 13, 1, 138, dict(seed=88)),
    "cz_ties": (46, 3, 256, 512, 138, dict(seed=89, ties="ints")),
    "cz_zeros": (46, 3, 256, 512, 138, dict(seed=90, ties="zeros")),
}

# past the templates (S <= 5, rows of one ring stage): S 6 and 7 (P of 1
# and 4 phonemes a lane), rows wider than 4,073 columns at S 3 and 6, and
# S 120 at P 128, whose carry and buffer exceed shared memory (carry in
# device memory)
VITERBI_WIDE_CASES = {
    "P46_S6": (46, 6, 13, 37, 276, dict(seed=109, ties="ints")),
    "P20_S7": (20, 7, 13, 37, 140, dict(seed=110, ties="zeros")),
    "P128_S7": (128, 7, 13, 37, 896, dict(seed=111)),
    "P46_S3_D4100": (46, 3, 13, 37, 4100, dict(seed=112, ties="ints")),
    "P100_S6_D5000": (100, 6, 5, 20, 5000, dict(seed=113, ties="zeros")),
    "P128_S120": (128, 120, 2, 9, 15360, dict(seed=114)),
}


def held_ms(fn, iters: int = 20, warmup: int = 2) -> float:
    """Milliseconds of card time a call of ``fn`` takes, as
    mlp_variants.cuda_ms (CUDA events around ``iters`` calls after
    ``warmup``), but with the card held by a spin kernel while the host
    enqueues the calls (up to 50 ms of them): a kernel that runs shorter
    than its wrapper's host work is timed, where cuda_ms times the host's
    rate of launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t
    torch.cuda._sleep(int(2e9 * min(1.5 * host_s * iters, 0.05)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _sync(dev) -> None:
    """Wait for the card, so a fault shows at the check that caused it."""
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit: float32 compared as its bits, so -0.0 is not
    +0.0 (torch.equal compares values)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def lrtrace_case(dev, n, F, K, S, seed, ties=False, dead=False):
    """Kernel F's inputs: sink records [F, n, S] built to flush often.
    Random-walk values with dead stretches (NEG) and word starts that jump
    to the current frame every 20-80 frames; or, with ``ties``,
    small-integer values (lr == last_lr and lr == cand_lr often) and, for
    about half the streams, word starts 0-2 frames behind the frame
    (cand_end == w0 often).  Word columns a permutation of the sinks but
    the filler's; ragged n_valid (0 and F among them, stream 0 whole; all
    0 with ``dead``); random n_dec.  -> the lrtrace_scan arguments but
    the two prunings."""
    rng = np.random.default_rng(seed)
    nd = rng.integers(0, 5000, n)
    f = np.arange(F)[:, None, None]
    seg = rng.integers(20, 80, (1, n, S))
    sw = nd[None, :, None] + f // seg * seg
    if ties:
        sv = rng.integers(-3, 1, (F, n, S)).astype(np.float64)
        near = rng.random(n) < 0.5
        sw[:, near] = (nd[None, :, None] + np.maximum(
            f + 1 - rng.integers(0, 3, (F, n, S)), 0))[:, near]
    else:
        sv = np.cumsum(rng.normal(0, 1, (F, n, S)), axis=0) - 40
    sv[rng.random((F, n, S)) < 0.1] = NEG
    fs = int(rng.integers(0, S))
    ws = rng.permutation([c for c in range(S) if c != fs])[:K]
    nv = rng.integers(0, F + 1, n)
    nv[2::7], nv[::5] = 0, F
    if dead:
        nv[:] = 0
    t = lambda a, dt: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a).astype(dt)).to(dev)
    return (lrtrace_init_state(K, n, dev), t(sv, np.float32),
            t(sw, np.int32), t(ws, np.int32), fs, t(nd, np.int32),
            t(nv, np.int32))


def lrtrace_equal(got, want) -> dict:
    """Field -> bit-equal, over the state and both event records."""
    names = ("last_lr", "cand_lr", "cand_start", "cand_end", "prev_end",
             "dumped")
    out = {k: bit_equal(a, b) for k, a, b in zip(names, got[0], want[0])}
    for r in range(2):
        for k in got[1][r]:
            out[f"rec{r + 1}_{k}"] = bit_equal(got[1][r][k], want[1][r][k])
    return out


def check_lrtrace_cases(scan, dev, cases=LRTRACE_CASES) -> list:
    """``scan`` (lrtrace_scan's arguments) against the plain version on
    every case of LRTRACE_CASES, both time prunings; on records 4 bytes
    off 16-byte alignment (S 4, which the kernel then copies by column);
    and on two blocks chained through the state (n 13, F 77 split at 30)
    against one.  -> one record per check, with its bad fields."""
    recs = []
    for case, (n, F, K, S, kw) in cases.items():
        args = lrtrace_case(dev, n, F, K, S, **kw)
        sp = LRTRACE_SCORE[kw.get("ties", False)]
        for tp in LRTRACE_PRUNING:
            got = scan(*args, tp, sp)
            want = lrtrace.lrtrace_scan_plain(*args, tp, sp)
            _sync(dev)
            eq = lrtrace_equal(got, want)
            recs.append(dict(case=case, n=n, F=F, K=K, S=S, time_pruning=tp,
                             emits=[int(want[1][r]["emit"].sum())
                                    for r in range(2)],
                             bad=[k for k, v in eq.items() if not v]))
    st, sv, sw, ws, fs, nd, nv = lrtrace_case(dev, 13, 77, 2, 4, seed=74)
    off = [torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
           .view(t.shape).copy_(t) for t in (sv, sw)]
    got = scan(st, *off, ws, fs, nd, nv, 40, -1e30)
    want = lrtrace.lrtrace_scan_plain(st, sv, sw, ws, fs, nd, nv, 40, -1e30)
    _sync(dev)
    eq = lrtrace_equal(got, want)
    recs.append(dict(case="misaligned", n=13, F=77, K=2, S=4,
                     time_pruning=40, bad=[k for k, v in eq.items() if not v]))
    st, sv, sw, ws, fs, nd, _ = lrtrace_case(dev, 13, 77, 2, 4, seed=73)
    full = torch.full_like(nd, 77)
    one = scan(st, sv, sw, ws, fs, nd, full, 40, -1e30)
    s1, e1 = scan(st, sv[:30].contiguous(), sw[:30].contiguous(), ws, fs, nd,
                  full - 47, 40, -1e30)
    s2, e2 = scan(s1, sv[30:].contiguous(), sw[30:].contiguous(), ws, fs,
                  nd + 30, full - 30, 40, -1e30)
    two = (s2, tuple({k: torch.cat([a[k], b[k]], dim=1) for k in a}
                     for a, b in zip(e1, e2)))
    _sync(dev)
    eq = lrtrace_equal(two, one)
    recs.append(dict(case="two_blocks", n=13, F=77, K=2, S=4,
                     time_pruning=40, bad=[k for k, v in eq.items() if not v]))
    return recs


def viterbi_case(dev, P, S, B, T, D, seed, ties=None):
    """Kernel C's inputs: (spec, log_post [B, T, D], t0 [B], n_valid [B]
    ragged with 0 and T among them, row 0 whole).  Dirichlet
    log-posteriors, or with ``ties`` small integers: "ints" 0, -1, -2, -3
    (0 as -0.0) with the CZ loop's constants, "zeros" +0.0 or -0.0 at 70%
    and -1, -2 elsewhere with w_penalty -0.0, tr_curr +0.0 and tr_next
    -0.0 (so exits of -0.0 and +0.0 tie)."""
    rng = np.random.default_rng(seed)
    spec = phnloop.PhnLoopSpec(n_phonemes=P, n_states=S, w_penalty=-4.6875)
    if ties == "ints":
        lp = -np.round(rng.uniform(0, 3, (B, T, D)))
    elif ties == "zeros":
        lp = np.where(rng.random((B, T, D)) < 0.7,
                      rng.choice([0.0, -0.0], (B, T, D)),
                      -rng.integers(1, 3, (B, T, D)))
        spec = phnloop.PhnLoopSpec(n_phonemes=P, n_states=S, w_penalty=-0.0,
                                   log_tr_curr=0.0, log_tr_next=-0.0)
    else:
        lp = np.log(rng.dirichlet(np.ones(D), size=(B, T)))
    nv = rng.integers(0, T + 1, B)
    nv[2::5], nv[::4] = 0, T
    t = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a)).to(dev)
    return (spec, t(lp.astype(np.float32)),
            t(rng.integers(0, 5000, B).astype(np.int32)),
            t(nv.astype(np.int32)))


def _spec_args(spec):
    return (spec.n_phonemes, spec.n_states, spec.w_penalty, spec.log_tr_curr,
            spec.log_tr_next)


def viterbi_equal(got, want, n_valid=None) -> dict:
    """Part -> bit-equal: the carry, and the History on rows < n_valid[b]
    (all rows without n_valid)."""
    T, B = want[1][0].shape
    out = {w: bit_equal(a, b)
           for a, b, w in zip(got[0], want[0], ("alphas", "ent"))}
    valid = torch.ones((T, B), dtype=torch.bool, device=want[1][0].device)
    if n_valid is not None:
        valid = torch.arange(T, device=valid.device)[:, None] < \
            n_valid[None, :]
    for a, b, w in zip(got[1], want[1], ("max_phn", "h_ent", "h_alpha")):
        zero = torch.zeros((), dtype=a.dtype, device=a.device)
        out[w] = bit_equal(torch.where(valid, a, zero),
                           torch.where(valid, b, zero))
    return out


def check_viterbi_cases(block, ragged, dev, cases=VITERBI_CASES) -> list:
    """``block`` (viterbi_block's arguments) and ``ragged``
    (viterbi_block_ragged's) against their plain versions on every case of
    VITERBI_CASES: C from the initial carry at t0 17; C over two blocks
    (split at T // 2 - 1) against one; C' over two ragged blocks chained
    through the carry and t0 + n_valid, each against the plain version's
    chain.  -> one record per check, with its bad parts."""
    recs = []
    for case, (P, S, B, T, D, kw) in cases.items():
        spec, lp, t0, nv = viterbi_case(dev, P, S, B, T, D, **kw)
        args = _spec_args(spec)
        carry = phnloop.init_carry(spec, B, dev)
        checks = {}
        got = block(carry, lp, 17, *args)
        want = phnloop_viterbi.viterbi_block_plain(carry, lp, 17, *args)
        checks["C"] = viterbi_equal(got, want)
        if T >= 2:
            h = T // 2 - 1
            c1, h1 = block(carry, lp[:, :h].contiguous(), 17, *args)
            c2, h2 = block(c1, lp[:, h:].contiguous(), 17 + h, *args)
            two = (c2, tuple(torch.cat([x, y]) for x, y in zip(h1, h2)))
            checks["C_two_blocks"] = viterbi_equal(two, got)
        ck = cp = carry
        lp2 = lp.flip(1).contiguous()          # the second block's frames
        nv2 = nv.flip(0).contiguous()
        for i, (x, t_0, n_v) in enumerate(((lp, t0, nv),
                                           (lp2, t0 + nv, nv2))):
            gk = ragged(ck, x, t_0, n_v, *args)
            gp = phnloop_viterbi.viterbi_block_ragged_plain(cp, x, t_0, n_v,
                                                            *args)
            checks[f"C'_block{i + 1}"] = viterbi_equal(gk, gp, n_v)
            ck, cp = gk[0], gp[0]
        _sync(dev)
        recs.append(dict(case=case, P=P, S=S, B=B, T=T, D=D,
                         ties=kw.get("ties"), bad=[
                             f"{c}:{k}" for c, d in checks.items()
                             for k, v in d.items() if not v]))
    return recs


def serving_lrtrace(dev):
    """Kernel F's timed case: n 256 x F 512 x K 2, S 4, time pruning 40."""
    return (*lrtrace_case(dev, 256, 512, 2, 4, seed=61), 40, -1e30)


def serving_viterbi(dev):
    """Kernel C' and C's timed cases at the CZ loop (chip_smoke.py's): C'
    at B 256 x T 512 from a carry one ragged block in, C at B 256 x T 500
    from the initial carry.  -> (C' args, C args)."""
    P, S, B, T = 46, 3, 256, 512
    rng = np.random.default_rng(5)
    spec = phnloop.PhnLoopSpec(n_phonemes=P, n_states=S, w_penalty=-4.6875)
    args = _spec_args(spec)

    def lp_of(t):
        return torch.from_numpy(np.log(rng.dirichlet(
            np.ones(P * S), size=(B, t))).astype(np.float32)).to(dev)

    def i32(a):
        return torch.from_numpy(np.asarray(a, np.int32)).to(dev)

    lp0, lp = lp_of(T), lp_of(T)
    t0 = rng.integers(0, 5000, B)
    nv0 = rng.integers(0, T + 1, B)
    nv = rng.integers(0, T + 1, B)
    nv[::9], nv[1::9] = 0, T
    carry, _ = phnloop_viterbi.viterbi_block_ragged_plain(
        phnloop.init_carry(spec, B, dev), lp0, i32(t0), i32(nv0), *args)
    rargs = (carry, lp, i32(t0 + nv0), i32(nv), *args)
    rng_c = np.random.default_rng(4)
    lpc = torch.from_numpy(np.log(rng_c.dirichlet(
        np.ones(P * S), size=(B, 500))).astype(np.float32)).to(dev)
    cargs = (phnloop.init_carry(spec, B, dev), lpc, 0, *args)
    return rargs, cargs


def main(argv) -> int:
    ablate = "--ablate" in argv
    argv = [a for a in argv if a != "--ablate"]
    n_ablate = argv.index("--") if "--" in argv else len(argv)
    argv = [a for a in argv if a != "--"]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ERROR: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    kernel_f = 'extern "C" int lrtrace_scan(' in Path(argv[0]).read_text()
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    # tagged by position: two sources may share a file name
    srcs, checked = {}, []
    for i, a in enumerate(argv):
        tag = f"{i}:{Path(a).stem}"
        srcs[tag] = Path(a)
        checked.append(tag)
        text = Path(a).read_text()
        for what, edits in ABLATIONS if ablate and i < n_ablate else ():
            if not all(old in text for old, _ in edits):
                continue
            cut = text
            for old, new in edits:
                cut = cut.replace(old, new)
            p = out_dir / f"{Path(a).stem}_{i}_{what}.cu"
            p.write_text(cut)
            srcs[f"{tag}:{what}"] = p
    with ThreadPoolExecutor(len(srcs)) as ex:
        libs = dict(zip(srcs, ex.map(build, srcs, srcs.values())))
    bind = lrtrace.bind if kernel_f else phnloop_viterbi.bind
    for lib in libs.values():
        if not kernel_f and not hasattr(lib, "phn_viterbi_max_row"):
            # an older source, from before the row limit: any row
            lib.phn_viterbi_max_row = lambda: 1 << 30
        bind(lib)

    def calls(lib):
        if kernel_f:
            return dict(F=lambda *a: lrtrace.launch(lib, *a))
        return dict(
            C=lambda carry, lp, t0, *a: phnloop_viterbi.launch(
                lib, carry, lp, t0, None, None, *a),
            Cr=lambda carry, lp, t0, nv, *a: phnloop_viterbi.launch(
                lib, carry, lp, 0, t0, nv, *a))

    ok = True
    for name in checked:
        c = calls(libs[name])
        recs = (check_lrtrace_cases(c["F"], dev) if kernel_f else
                check_viterbi_cases(c["C"], c["Cr"], dev))
        bad = [r for r in recs if r["bad"]]
        ok = ok and not bad
        print(json.dumps({"check": name, "cases": len(recs),
                          "equal": not bad, "bad": bad[:10]}), flush=True)

    if kernel_f:
        fargs = serving_lrtrace(dev)
        timed = {"F n256 x F512 x K2": (lambda c: c["F"](*fargs), 512)}
    else:
        rargs, cargs = serving_viterbi(dev)
        timed = {"C' B256 x T512": (lambda c: c["Cr"](*rargs), 512),
                 "C B256 x T500": (lambda c: c["C"](*cargs), 500)}
    timers = {"ms": cuda_ms, "held_ms": held_ms}
    ms = {name: {f"{k} {w}": [] for k in timed for w in timers}
          for name in libs}
    for name in [*libs, *reversed(libs)]:
        c = calls(libs[name])
        for k, (fn, _) in timed.items():
            for w, timer in timers.items():
                ms[name][f"{k} {w}"].append(timer(lambda: fn(c), iters=20))
    for name, t in ms.items():
        c = calls(libs[name])
        rec = {"time_ms": name, **t}
        for k, (fn, frames) in timed.items():
            mhz = sm_clock(lambda: fn(c), max(t[f"{k} ms"][0], 0.2))
            rec[f"{k} sm_clock_mhz"] = mhz
            for w in timers:
                rec[f"{k} {w} clocks_a_frame"] = [
                    v * 1e-3 * mhz * 1e6 / frames for v in t[f"{k} {w}"]]
        print(json.dumps(rec), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
