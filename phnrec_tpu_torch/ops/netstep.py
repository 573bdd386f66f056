"""Kernel B: the dense network-Viterbi block (csrc/netstep.cu) and its
plain PyTorch version.

Counterpart of phnrec_tpu/ops/pallas_netstep.py::build_net_block_fn.  One
call runs all F frames of the max-plus network step for n streams:

    carry = (alpha [n, E] f32, wt [n, E] i32, entry [n, M] f32,
             entry_wt [n, M] i32)
    obs [F, n, E] f32, n_valid [n] i32, n_dec [n] i32, beam [n] f32
      -> (carry', (sink_val [F, n, S] f32, sink_wt [F, n, S] i32))

Rows with frame index >= n_valid keep their carry; word times reset to
n_dec + 1 + frame.  The plain version is the frame loop of
``DenseKWSScan.step`` (decoder/stknet.py).  The kernel exploits the
structure ``extract_structure`` verifies (uniform-S left-to-right models:
three in-model candidates per state, the exit from each model's last
state) and reads the exit->entry closure and the sinks from one dense
table by destination column and source model, -inf on dead edges, each
distinct column once, walked over all sources ascending with the first
maximum kept (``dense_tables``).  All of it is adds and compares, so the
kernel is bit-equal to the plain version on live entries (value >
NEG / 2); dead entries hold different never-winning values, as in the
JAX package.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from phnrec_tpu_torch.decoder.stknet import NEG, _device_cache
from phnrec_tpu_torch.ops import _build

LAUNCHES = 0
# the networks the kernel takes: E states at most (csrc/netstep.cu,
# MAX_E), any number of models and sinks
MAX_E = 1024

Carry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def extract_structure(dense) -> Optional[dict]:
    """Verify the compiled network is uniform-S left-to-right and
    extract the structured weights; None if the topology is irregular
    (skips, TEE within-model edges, ragged state counts).  Copy of
    phnrec_tpu/ops/pallas_netstep.py:48-87 (host numpy)."""
    A_in = np.asarray(dense.A_in)
    A_ex = np.asarray(dense.A_ex)
    M, E = dense.M, dense.E
    neg2 = float(NEG) / 2
    if M == 0 or E == 0 or E % M:
        return None
    S_M = E // M
    # the used-mask check below doubles as the topology verification:
    # if states were NOT contiguous blocks of S_M per model, the real
    # entry/self/advance edges would fall outside the assumed pattern
    # and the "edge outside the pattern" test rejects the network
    w_self = np.full(E, NEG, np.float32)
    w_adv = np.full(E, NEG, np.float32)
    w_entry = np.full(E, NEG, np.float32)
    used = np.zeros_like(A_in, bool)
    for e in range(E):
        m = e // S_M
        w_self[e] = A_in[M + e, e]
        used[M + e, e] = True
        if e % S_M:
            w_adv[e] = A_in[M + e - 1, e]
            used[M + e - 1, e] = True
        else:
            w_entry[e] = A_in[m, e]
            used[m, e] = True
    if np.any(A_in[~used] > neg2):      # an edge outside the pattern
        return None
    w_exit = np.full(M, NEG, np.float32)
    used_ex = np.zeros_like(A_ex, bool)
    for m in range(M):
        w_exit[m] = A_ex[(m + 1) * S_M - 1, m]
        used_ex[(m + 1) * S_M - 1, m] = True
    if np.any(A_ex[~used_ex] > neg2):
        return None
    return dict(S_M=S_M, w_self=w_self, w_adv=w_adv, w_entry=w_entry,
                w_exit=w_exit)


def net_block_plain(dense, carry: Carry, obs: torch.Tensor,
                    n_valid: torch.Tensor, n_dec: torch.Tensor,
                    beam: torch.Tensor):
    """The block as a Python loop of ``DenseKWSScan.step`` over frames,
    on any device (the JAX package's dense scan, stknet.py:916-950)."""
    F = obs.shape[0]
    S = dense.n_sinks
    n_valid = n_valid.to(torch.int32)
    n_dec = n_dec.to(torch.int32)
    svs, sws = [], []
    for i in range(F):
        carry, (sv, sw) = dense.step(carry, obs[i], n_dec + (1 + i),
                                     n_valid > i, beam)
        svs.append(sv[:, :S])
        sws.append(sw[:, :S])
    return carry, (torch.stack(svs), torch.stack(sws))


def compare_live(got, want) -> dict:
    """Checks of a block's output ``got`` against the plain version's
    ``want`` (both (carry, (sink_val, sink_wt))): the same entries live
    (value > NEG / 2; both write never-winning values below NEG / 2 on
    dead paths), and records and carry bit-equal on them."""
    (ck, (svk, swk)), (cp, (svp, swp)) = got, want
    live = {"sink": svp > NEG / 2, "alpha": cp[0] > NEG / 2,
            "entry": cp[2] > NEG / 2}

    def eq(g, w, m):
        return torch.equal(torch.where(m, g, torch.zeros_like(g)),
                           torch.where(m, w, torch.zeros_like(w)))
    return {"sink_live": torch.equal(svk > NEG / 2, live["sink"]),
            "alpha_live": torch.equal(ck[0] > NEG / 2, live["alpha"]),
            "entry_live": torch.equal(ck[2] > NEG / 2, live["entry"]),
            "sink_val": eq(svk, svp, live["sink"]),
            "sink_wt": eq(swk, swp, live["sink"]),
            "alpha": eq(ck[0], cp[0], live["alpha"]),
            "wt": eq(ck[1], cp[1], live["alpha"]),
            "entry": eq(ck[2], cp[2], live["entry"]),
            "entry_wt": eq(ck[3], cp[3], live["entry"])}


def check_limits(E: int, S: int, F: int, n: int) -> None:
    """Raise where the kernel cannot run: more than MAX_E states (each
    lane of a stream's warp holds up to 32), no sink, or a block whose
    records overflow 32-bit offsets."""
    if E > MAX_E or S < 1:
        raise ValueError(f"kernel B takes E <= {MAX_E} states and S >= 1 "
                         f"sinks (got E {E}, S {S})")
    if F * n * max(E, S) >= 2 ** 31:
        raise ValueError("block too large for 32-bit offsets")


def count_ties(dense, carry: Carry, obs: torch.Tensor,
               n_valid: torch.Tensor, n_dec: torch.Tensor,
               beam: torch.Tensor) -> Tuple[int, int]:
    """(closure, sink) decisions of the block's live frames where two or
    more live edges tie for a live best candidate x[r] + A[r, d]: the
    decisions the first-maximum rule settles.  Runs the plain loop."""
    tb = dense.tables(obs.device)
    A_cs = tb["A_cs"][:, :dense.n_sinks]
    n_valid = n_valid.to(torch.int32)
    n_dec = n_dec.to(torch.int32)
    ties = [0, 0]
    for i in range(obs.shape[0]):
        live = n_valid > i
        carry, _ = dense.step(carry, obs[i], n_dec + (1 + i), live, beam)
        # a live frame's carry holds its beamed alpha: its exits
        x = torch.amax(carry[0][:, :, None] + tb["A_ex"][None], dim=1)
        for k, A in enumerate((tb["A_cm"], A_cs)):
            c = x[:, :, None] + A[None]                     # [n, M, D]
            best = c.amax(dim=1, keepdim=True)
            n_best = ((c == best) & (A[None] > NEG / 2)).sum(1)
            ties[k] += int(((n_best > 1) & (best[:, 0] > NEG / 2)
                            & live[:, None]).sum())
    return ties[0], ties[1]


def _stride(M: int) -> int:
    """The tables' row stride: M rounded up to 4 floats (16-byte rows),
    and an odd number of 16-byte units, so the 16-byte loads of a warp's
    lanes from rows one stride apart fall in distinct banks."""
    P = -(-M // 4) * 4
    return P + 4 if (P // 4) % 2 == 0 else P


def dense_tables(A_cm: np.ndarray, R_cm: np.ndarray, A_cs: np.ndarray):
    """The kernel's edge tables.  The destination columns (d < M: the
    closure's A_cm[:, d]; d >= M: sink d - M's A_cs[:, d - M]) by source
    model, -inf where the edge is dead (<= NEG / 2): tab f32 [U_pad, P]
    holds each distinct column once (a phone-loop filler's models share
    one), rows padded to a multiple of 32 and sources to the stride P with
    -inf; col_of i32 [M + S] maps each destination to its row; reset i8
    [M, P] is R_cm transposed (0 on dead edges).  Returns (tab, col_of,
    reset, U)."""
    M, S = A_cm.shape[0], A_cs.shape[1]
    P = _stride(M)
    A = np.concatenate([A_cm, A_cs], axis=1).T      # [D, src M]
    cols, col_of = np.unique(np.where(A > NEG / 2, A, -np.inf), axis=0,
                             return_inverse=True)
    U = cols.shape[0]
    tab = np.full((-(-U // 32) * 32, P), -np.inf, np.float32)
    tab[:U, :M] = cols
    reset = np.zeros((M, P), np.int8)
    reset[:, :M] = (R_cm.T & (A_cm.T > NEG / 2))
    return tab, col_of.reshape(-1).astype(np.int32), reset, U


class NetBlock:
    """Kernel B bound to one network's structured tables.  Calling it runs
    one block: the plain version for CPU tensors, the kernel (one launch
    for all F frames) for CUDA tensors; anything the kernel does not take
    raises."""

    def __init__(self, dense, structure: dict):
        self.dense = dense
        self.M, self.E, self.S = dense.M, dense.E, dense.n_sinks
        self.S_M = structure["S_M"]
        tab, col_of, reset, self.U = dense_tables(
            np.asarray(dense.A_cm), np.asarray(dense.R_cm, bool),
            np.asarray(dense.A_cs)[:, :self.S])
        self.P = tab.shape[1]
        self._host = dict(
            w_self=structure["w_self"], w_adv=structure["w_adv"],
            w_entry=structure["w_entry"], w_exit=structure["w_exit"],
            tab=tab, col_of=col_of, reset=reset)

    def _tables(self, device):
        return _device_cache(self, device, lambda d: {
            k: torch.from_numpy(v).to(d) for k, v in self._host.items()})

    def __call__(self, carry: Carry, obs: torch.Tensor,
                 n_valid: torch.Tensor, n_dec: torch.Tensor,
                 beam: torch.Tensor):
        if obs.device.type == "cpu":
            return net_block_plain(self.dense, carry, obs, n_valid, n_dec,
                                   beam)
        if obs.dim() != 3 or obs.shape[2] != self.E:
            raise ValueError(f"obs must be [F, n, {self.E}]")
        F, n, E = obs.shape
        M, S = self.M, self.S
        check_limits(E, S, F, n)
        device = _build.cuda_device(obs)
        alpha, wt, entry, ewt = carry
        _build.require(obs, "obs", torch.float32, (F, n, E), device)
        _build.require(alpha, "carry alpha", torch.float32, (n, E), device)
        _build.require(wt, "carry wt", torch.int32, (n, E), device)
        _build.require(entry, "carry entry", torch.float32, (n, M), device)
        _build.require(ewt, "carry entry_wt", torch.int32, (n, M), device)
        _build.require(n_valid, "n_valid", torch.int32, (n,), device)
        _build.require(n_dec, "n_dec", torch.int32, (n,), device)
        _build.require(beam, "beam", torch.float32, (n,), device)
        t = self._tables(device)
        out = [torch.empty_like(alpha), torch.empty_like(wt),
               torch.empty_like(entry), torch.empty_like(ewt)]
        sv = torch.empty((F, n, S), dtype=torch.float32, device=device)
        sw = torch.empty((F, n, S), dtype=torch.int32, device=device)
        lib = _lib()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.phn_net_block(
                obs.data_ptr(), alpha.data_ptr(), wt.data_ptr(),
                entry.data_ptr(), ewt.data_ptr(),
                t["w_self"].data_ptr(), t["w_adv"].data_ptr(),
                t["w_entry"].data_ptr(), t["w_exit"].data_ptr(),
                t["tab"].data_ptr(), t["col_of"].data_ptr(),
                t["reset"].data_ptr(), n_valid.data_ptr(),
                n_dec.data_ptr(), beam.data_ptr(),
                F, n, E, M, S, self.S_M, self.P, self.U,
                *(o.data_ptr() for o in out), sv.data_ptr(), sw.data_ptr(),
                stream)
        _build.check(err, "netstep")
        global LAUNCHES
        LAUNCHES += 1
        return tuple(out), (sv, sw)


def _lib():
    lib = _build.load("netstep")
    fn = lib.phn_net_block
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p] * 7)
        fn.restype = ctypes.c_int
    return lib


def build_net_block_fn(dense) -> Optional[NetBlock]:
    """Kernel B for the network of ``dense`` (a DenseKWSScan), or None
    when its topology is irregular (the JAX package's structure gate;
    callers then run the plain dense step)."""
    st = extract_structure(dense)
    return None if st is None else NetBlock(dense, st)
