"""Kernel E: the decode-mode dense network-Viterbi block
(csrc/netdecode.cu) and its plain PyTorch version.

Counterpart of the frame scan of ``DenseKWSScan.step_decode`` that
phnrec_tpu's MultiStreamStkDecode runs over each block
(phnrec_tpu/multistream.py:1357-1371, the step at
phnrec_tpu/decoder/stknet.py:961-996).  One call runs all F frames for n
streams:

    carry = (alpha [n, E] f32, entry [n, M] f32, entry_edge [n, M] i32)
    obs [n, F, E] f32, n_valid [n] i32, beam [n] f32
      -> (carry', records), records a dict of [n, F, .] tensors:
         in_am [E], ex_am, cm_am, entry_edge [M] (ids, int16 or int32);
         entry_val [M], sink_val [S] f32; cs_am [S] (ids)

the layout kernel H and the serving window read.  Rows with frame index >=
n_valid keep their carry and still write their records.  The kernel takes
the structure ``netstep.extract_structure`` verifies (kernel B's); the
in-model winner's id comes from a per-state table of its three candidates'
ids, the closure's and the sinks' from an id table beside kernel B's
distinct-column weight tables.  Adds and compares only: ids and values are
bit-equal to the plain version wherever their value is live (> NEG / 2)
— in_am where the beamed alpha is, ex_am where the exit value is, cm_am
where the new entry is, entry_edge where the carried entry is, cs_am where
the sink value is (``compare_live``); dead entries hold other values and
ids, which no walk reaches.

The kernel has two instances of one design, picked by the network's sizes
(``plan_instance``): the redux instance (few distinct columns, at most 64
destinations, a phoneme loop's network) takes each column's best source
by two warp reductions over the exits in registers; the general instance
stages the exits in shared memory and reduces each column over lanes.
Both count as this kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from phnrec_tpu_torch.decoder.stknet import NEG, _device_cache
from phnrec_tpu_torch.ops import _build, netstep, nettrace

LAUNCHES = 0
MAX_E = netstep.MAX_E
# the redux instance (csrc/netdecode.cu): networks of at most REDUX_COLUMNS
# distinct destination columns and 64 destinations, at most REDUX_EPL
# states a lane (the instance's: int32 ids round the count up to a power
# of two); the general instance takes the rest
REDUX_COLUMNS = 4
REDUX_EPL = 8
EPLS = (1, 2, 3, 4, 5, 6, 8, 12, 16, 24, 32)   # netdense.cuh's instances

Carry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
ID_KEYS = ("in_am", "ex_am", "cm_am", "entry_edge", "cs_am")
RECORDS = nettrace.NEEDS            # the records kernel H walks


def net_decode_block_plain(dense, carry: Carry, obs: torch.Tensor,
                           n_valid: torch.Tensor, beam: torch.Tensor,
                           id_dtype=torch.int32, values: bool = False):
    """The block as a Python loop of ``DenseKWSScan.step_decode`` over
    frames, on any device.  Returns (carry', records [n, F, .], ids cast
    to ``id_dtype``); with ``values`` the records also hold each frame's
    beamed alpha [E], exit values and new entries [M] (``compare_live``'s
    liveness)."""
    F = obs.shape[1]
    n_valid = n_valid.to(torch.int32)
    recs = {k: [] for k in RECORDS + (("alpha", "exit_val", "nentry")
                                       if values else ())}
    for i in range(F):
        carry, rec = dense.step_decode(carry, obs[:, i], n_valid > i, beam,
                                       values=values)
        for k, v in rec.items():
            recs[k].append(v)
    out = {}
    for k, v in recs.items():
        t = torch.stack(v, dim=1) if F else _empty(dense, k, obs)
        out[k] = t.to(id_dtype) if k in ID_KEYS else t
    return carry, out


def _empty(dense, k: str, obs: torch.Tensor) -> torch.Tensor:
    w = {"in_am": dense.E, "alpha": dense.E, "sink_val": dense.n_sinks,
         "cs_am": dense.n_sinks}.get(k, dense.M)
    dt = torch.int32 if k in ID_KEYS else torch.float32
    return torch.empty((obs.shape[0], 0, w), dtype=dt, device=obs.device)


def compare_live(got, want) -> dict:
    """Checks of a block's output ``got`` (carry, records) against the plain
    version's ``want`` (run with ``values``): every value live where the
    plain one is and bit-equal there, and every id equal where its value
    is live."""
    (ck, rk), (cp, rp) = got, want
    neg2 = float(NEG) / 2

    def eq(g, w, m):
        # floats by their bits, ids of either width as int32
        g, w = ((g.view(torch.int32), w.view(torch.int32))
                if g.is_floating_point() else
                (g.to(torch.int32), w.to(torch.int32)))
        return torch.equal(torch.where(m, g, torch.zeros_like(g)),
                           torch.where(m, w, torch.zeros_like(w)))

    live = {"alpha": rp["alpha"] > neg2, "exit": rp["exit_val"] > neg2,
            "nentry": rp["nentry"] > neg2, "entry": rp["entry_val"] > neg2,
            "sink": rp["sink_val"] > neg2}
    c_alpha, c_entry = cp[0] > neg2, cp[1] > neg2
    return {
        "entry_val_live": torch.equal(rk["entry_val"] > neg2, live["entry"]),
        "sink_val_live": torch.equal(rk["sink_val"] > neg2, live["sink"]),
        "entry_val": eq(rk["entry_val"], rp["entry_val"], live["entry"]),
        "sink_val": eq(rk["sink_val"], rp["sink_val"], live["sink"]),
        "in_am": eq(rk["in_am"], rp["in_am"], live["alpha"]),
        "ex_am": eq(rk["ex_am"], rp["ex_am"], live["exit"]),
        "cm_am": eq(rk["cm_am"], rp["cm_am"], live["nentry"]),
        "entry_edge": eq(rk["entry_edge"], rp["entry_edge"], live["entry"]),
        "cs_am": eq(rk["cs_am"], rp["cs_am"], live["sink"]),
        "alpha_live": torch.equal(ck[0] > neg2, c_alpha),
        "entry_live": torch.equal(ck[1] > neg2, c_entry),
        "alpha": eq(ck[0], cp[0], c_alpha),
        "entry": eq(ck[1], cp[1], c_entry),
        "carry_entry_edge": eq(ck[2], cp[2], c_entry)}


def check_limits(E: int, S: int, F: int, n: int) -> None:
    if E > MAX_E or S < 1:
        raise ValueError(f"kernel E takes E <= {MAX_E} states and S >= 1 "
                         f"sinks (got E {E}, S {S})")
    if F * n * max(E, S) >= 2 ** 31:
        raise ValueError("block too large for 32-bit offsets")


def plan_instance(E: int, D: int, U: int, id16: bool) -> str:
    """The instance a launch takes, by the network's sizes: "redux" or
    "general" (as phn_net_decode picks it)."""
    epl = next(c for c in EPLS if 32 * c >= E)
    if not id16:
        epl = 1 << (epl - 1).bit_length()
    return ("redux" if U <= REDUX_COLUMNS and D <= 64 and epl <= REDUX_EPL
            else "general")


def id_tables(dense, structure: dict, P: int) -> Dict[str, np.ndarray]:
    """The kernel's id tables: id_in [E, 4] i32 (per state, the edge ids
    of its self, advance and entry candidates, -1 where the candidate has
    no edge; the fourth column unused), id_exit [M] (each model's exit
    edge), ids [M + S, P] (per destination column — the closure's model
    entries, then the sinks — the edge id from each source model, -1 where
    no live edge)."""
    M, E, S = dense.M, dense.E, dense.n_sinks
    S_M = structure["S_M"]
    e = np.arange(E)
    id_in = np.full((E, 4), -1, np.int32)
    id_in[:, 0] = dense.I_in[M + e, e]
    adv = e[e % S_M != 0]
    id_in[adv, 1] = dense.I_in[M + adv - 1, adv]
    first = e[e % S_M == 0]
    id_in[first, 2] = dense.I_in[first // S_M, first]
    m = np.arange(M)
    id_exit = dense.I_ex[(m + 1) * S_M - 1, m].astype(np.int32)
    ids = np.full((M + S, P), -1, np.int32)
    ids[:M, :M] = np.where(dense.A_cm.T > NEG / 2, dense.I_cm.T, -1)
    ids[M:, :M] = np.where(dense.A_cs[:, :S].T > NEG / 2,
                           dense.I_cs[:, :S].T, -1)
    return dict(id_in=id_in, id_exit=id_exit, ids=ids)


class NetDecode:
    """Kernel E bound to one network's structured tables.  Calling it runs
    one block: the plain version for CPU tensors, the kernel (one launch
    for all F frames) for CUDA tensors; anything the kernel does not take
    raises."""

    def __init__(self, dense, structure: dict):
        self.dense = dense
        self.M, self.E, self.S = dense.M, dense.E, dense.n_sinks
        self.S_M = structure["S_M"]
        tab, col_of, _, self.U = netstep.dense_tables(
            np.asarray(dense.A_cm), np.asarray(dense.R_cm, bool),
            np.asarray(dense.A_cs)[:, :self.S])
        self.P = tab.shape[1]
        self._host = dict(
            w_self=structure["w_self"], w_adv=structure["w_adv"],
            w_entry=structure["w_entry"], w_exit=structure["w_exit"],
            tab=tab, col_of=col_of, **id_tables(dense, structure, self.P))

    def instance(self, id_dtype=torch.int32) -> str:
        """The kernel instance a launch with ``id_dtype`` ids takes."""
        return plan_instance(self.E, self.M + self.S, self.U,
                             id_dtype == torch.int16)

    def _tables(self, device):
        return _device_cache(self, device, lambda d: {
            k: torch.from_numpy(v).to(d) for k, v in self._host.items()})

    def __call__(self, carry: Carry, obs: torch.Tensor,
                 n_valid: torch.Tensor, beam: torch.Tensor,
                 id_dtype=torch.int32):
        if obs.device.type == "cpu":
            return net_decode_block_plain(self.dense, carry, obs, n_valid,
                                          beam, id_dtype)
        if obs.dim() != 3 or obs.shape[2] != self.E:
            raise ValueError(f"obs must be [n, F, {self.E}]")
        if id_dtype not in (torch.int16, torch.int32):
            raise TypeError("ids are int16 or int32")
        n, F, E = obs.shape
        M, S = self.M, self.S
        check_limits(E, S, F, n)
        device = _build.cuda_device(obs)
        alpha, entry, edge = carry
        _build.require(obs, "obs", torch.float32, (n, F, E), device)
        _build.require(alpha, "carry alpha", torch.float32, (n, E), device)
        _build.require(entry, "carry entry", torch.float32, (n, M), device)
        _build.require(edge, "carry entry_edge", torch.int32, (n, M),
                       device)
        _build.require(n_valid, "n_valid", torch.int32, (n,), device)
        _build.require(beam, "beam", torch.float32, (n,), device)
        t = self._tables(device)
        out = (torch.empty_like(alpha), torch.empty_like(entry),
               torch.empty_like(edge))
        width = {"in_am": E, "sink_val": S, "cs_am": S}
        recs = {k: torch.empty((n, F, width.get(k, M)),
                               dtype=id_dtype if k in ID_KEYS
                               else torch.float32, device=device)
                for k in RECORDS}
        lib = _lib()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.phn_net_decode(
                obs.data_ptr(), alpha.data_ptr(), entry.data_ptr(),
                edge.data_ptr(),
                *(t[k].data_ptr() for k in (
                    "w_self", "w_adv", "w_entry", "w_exit", "id_in",
                    "id_exit", "tab", "col_of", "ids")),
                n_valid.data_ptr(), beam.data_ptr(),
                F, n, E, M, S, self.S_M, self.P, self.U,
                int(id_dtype == torch.int16),
                *(o.data_ptr() for o in out),
                *(recs[k].data_ptr() for k in (
                    "in_am", "ex_am", "cm_am", "entry_edge", "entry_val",
                    "sink_val", "cs_am")),
                stream)
        _build.check(err, "netdecode")
        global LAUNCHES
        LAUNCHES += 1
        return out, recs


def _lib():
    lib = _build.load("netdecode")
    fn = lib.phn_net_decode
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p] * 11)
        fn.restype = ctypes.c_int
    return lib


def build_net_decode_fn(dense) -> Optional[NetDecode]:
    """Kernel E for the network of ``dense`` (a DenseKWSScan), or None when
    its topology is irregular (kernel B's structure gate): the caller then
    runs the edge-list scan, kernel G."""
    st = netstep.extract_structure(dense)
    return None if st is None else NetDecode(dense, st)
