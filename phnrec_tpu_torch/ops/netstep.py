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
state) and walks the exit->entry closure and the sinks over per-destination
lists of live edges, ascending source, strict-greater updates.  All of it
is adds and compares, so the kernel is bit-equal to the plain version on
live entries (value > NEG / 2); dead entries hold different
never-winning values, as in the JAX package.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from phnrec_tpu_torch.decoder.stknet import NEG, _device_cache
from phnrec_tpu_torch.ops import _build

LAUNCHES = 0

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


def _csr(A: np.ndarray, extra: Optional[np.ndarray] = None):
    """Per-destination lists of live edges (A[src, dst] > NEG / 2),
    ascending source: (ptr [D+1], src [nnz], w [nnz], extra[src, dst])."""
    live = A > NEG / 2
    src, w, ex, ptr = [], [], [], [0]
    for d in range(A.shape[1]):
        rows = np.nonzero(live[:, d])[0]
        src.extend(rows.tolist())
        w.extend(A[rows, d].tolist())
        if extra is not None:
            ex.extend(extra[rows, d].astype(np.int32).tolist())
        ptr.append(len(src))
    as_i = lambda v: np.asarray(v, np.int32)  # noqa: E731
    return (as_i(ptr), as_i(src), np.asarray(w, np.float32),
            as_i(ex) if extra is not None else None)


class NetBlock:
    """Kernel B bound to one network's structured tables.  Calling it runs
    one block: the plain version for CPU tensors, the kernel (one launch
    for all F frames) for CUDA tensors; anything the kernel does not take
    raises."""

    def __init__(self, dense, structure: dict):
        self.dense = dense
        self.M, self.E, self.S = dense.M, dense.E, dense.n_sinks
        self.S_M = structure["S_M"]
        cm_ptr, cm_src, cm_w, cm_rs = _csr(np.asarray(dense.A_cm),
                                           np.asarray(dense.R_cm))
        cs_ptr, cs_src, cs_w, _ = _csr(np.asarray(dense.A_cs)[:, :self.S])
        self._host = dict(
            w_self=structure["w_self"], w_adv=structure["w_adv"],
            w_entry=structure["w_entry"], w_exit=structure["w_exit"],
            cm_ptr=cm_ptr, cm_src=cm_src, cm_w=cm_w, cm_reset=cm_rs,
            cs_ptr=cs_ptr, cs_src=cs_src, cs_w=cs_w)
        self.threads = -(-max(self.E, self.M, self.S) // 32) * 32

    def _tables(self, device):
        # one element of padding keeps empty edge lists addressable
        return _device_cache(self, device, lambda d: {
            k: torch.from_numpy(v if v.size else np.zeros(1, v.dtype)).to(d)
            for k, v in self._host.items()})

    def __call__(self, carry: Carry, obs: torch.Tensor,
                 n_valid: torch.Tensor, n_dec: torch.Tensor,
                 beam: torch.Tensor):
        if obs.device.type == "cpu":
            return net_block_plain(self.dense, carry, obs, n_valid, n_dec,
                                   beam)
        device = _build.cuda_device(obs)
        if obs.dim() != 3:
            raise ValueError("obs must be [F, n, E]")
        F, n, E = obs.shape
        M, S = self.M, self.S
        if E != self.E or S < 1 or self.threads > 1024:
            raise ValueError(f"kernel B takes E = {self.E}, 1 <= S and "
                             f"max(E, M, S) <= 1024 (got E {E}, M {M}, "
                             f"S {S})")
        if F * n * max(E, S) >= 2 ** 31:
            raise ValueError("block too large for 32-bit offsets")
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
            err = lib.net_block(
                obs.data_ptr(), alpha.data_ptr(), wt.data_ptr(),
                entry.data_ptr(), ewt.data_ptr(),
                t["w_self"].data_ptr(), t["w_adv"].data_ptr(),
                t["w_entry"].data_ptr(), t["w_exit"].data_ptr(),
                t["cm_ptr"].data_ptr(), t["cm_src"].data_ptr(),
                t["cm_w"].data_ptr(), t["cm_reset"].data_ptr(),
                t["cs_ptr"].data_ptr(), t["cs_src"].data_ptr(),
                t["cs_w"].data_ptr(),
                n_valid.data_ptr(), n_dec.data_ptr(), beam.data_ptr(),
                F, n, E, M, S, self.S_M, self.threads,
                *(o.data_ptr() for o in out), sv.data_ptr(), sw.data_ptr(),
                stream)
        _build.check(err, "netstep")
        global LAUNCHES
        LAUNCHES += 1
        return tuple(out), (sv, sw)


def _lib():
    lib = _build.load("netstep")
    fn = lib.net_block
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p] * 7)
        fn.restype = ctypes.c_int
    return lib


def build_net_block_fn(dense) -> Optional[NetBlock]:
    """Kernel B for the network of ``dense`` (a DenseKWSScan), or None
    when its topology is irregular (the JAX package's structure gate;
    callers then run the plain dense step)."""
    st = extract_structure(dense)
    return None if st is None else NetBlock(dense, st)
