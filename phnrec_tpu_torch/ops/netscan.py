"""Kernel G: the edge-list network Viterbi scan (csrc/netscan.cu) and its
plain PyTorch version.

Counterpart of ``NetworkDecoder._step_fn`` / ``scan_block``
(phnrec_tpu/decoder/stknet.py:451-542), the ``lax.scan`` of one
ViterbiStep per frame over any compiled network, vmapped over utterances
in ``_scan_batch`` (:659-666).  One call runs all T frames for B rows:

    carry = (alpha [B, E] f32, wt [B, E] i32, entry [B, M] f32,
             entry_edge [B, M] i32, entry_wt [B, M] i32)
    obs [B, T, E] f32 per-state observations, t0 [B] i32 frames decoded
    before the block, n_valid [B] i32 absolute valid frame counts,
    beam [B] f32 pruning widths, the network's ``EdgeTables.tensors``
      -> (carry', records), records a dict of [B, T, .] tensors:
         in_am [E], ex_am, cm_am, entry_edge [M] i32; entry_val,
         exit_val [M] f32; sink_val [S] f32, cs_am, sink_wt [S] i32

Frame i of row b is time t = t0[b] + 1 + i (1-based); a frame with
t > n_valid[b] keeps the carry and still writes its records, as JAX does.
Each step, per destination, takes the maximum over its dense incoming-edge
row and the first slot holding it (pads, -1, read NEG and come last):
the in-model pass plus the observation; the beam cut against the row's
best; the exits from the cut alpha; the closure into the model entries
(cut by the same threshold, word time reset to t where the edge crosses
words) and into the sinks.  The kernel is equal to the plain version in
every record and the carry, float bits included.  It has two instances,
picked by the network's sizes (``plan_instance``): a warp a row within
the WARP_* limits below, a block a row past them; each counts its own
launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from phnrec_tpu_torch.decoder.stknet import NEG
from phnrec_tpu_torch.ops import _build

LAUNCHES = 0        # the block instance
WARP_LAUNCHES = 0   # the warp instance

# kernel G's two instances (csrc/netscan.cu): a warp a row where the
# network is within the limits below (the source holds the same numbers),
# else a block of 256 threads a row
INSTANCES = ("warp", "block")
WARP_MAX_E = 256     # 8 states a lane
WARP_MAX_K = 4       # in-model slots a state, exit slots a model
WARP_MAX_M = 64      # models (2 a lane)
WARP_MAX_D = 96      # closure and sink destinations, M + S (3 a lane)
WARP_MAX_U = 32      # distinct closure / sink rows
WARP_ROW_SLOTS = 24  # a lane's strided share of its distinct row
SMEM_MAX = 232448    # a block's shared memory on the H100 (227 KB)

Carry = Tuple[torch.Tensor, ...]
RECORDS = {"in_am": (torch.int32, "E"), "ex_am": (torch.int32, "M"),
           "cm_am": (torch.int32, "M"), "entry_edge": (torch.int32, "M"),
           "entry_val": (torch.float32, "M"),
           "sink_val": (torch.float32, "S"), "cs_am": (torch.int32, "S"),
           "sink_wt": (torch.int32, "S"), "exit_val": (torch.float32, "M")}
_TABLES = ("in_slot", "ex_slot", "cx_row", "cx_len", "cx_of", "cx_dst")


def slot_arrays(t) -> Dict[str, np.ndarray]:
    """Kernel G's tables from a network's ``EdgeTables``.  The in-model
    and exit rows [D, K] as slots [D, K, 4] int32 of (source index into
    the phase's values, edge id, word-time source, weight's float32 bits):
    the values are [entry (M) | alpha (E) | NEG] for the in-model pass
    (word times [entry_wt | wt]) and [alpha (E) | NEG] for the exits; a
    pad (id -1) reads the NEG sentinel with weight 0, so its value is NEG
    exactly, and has edge 0's word-time source, as JAX clips a -1 winner
    to edge 0.  The closure's and the sinks' rows (values [exit values (M)
    | NEG], word times those of the exits; a START edge reads the
    sentinel, a closure edge that crosses words has word-time source -1)
    as ``distinct_rows`` groups them."""
    M, E = t.n_models, t.n_states
    in_src = np.where(t.in_entry, np.clip(t.in_src, 0, M - 1),
                      M + np.clip(t.in_src, 0, E - 1))

    def slots(dense, src, wsel, w, sentinel):
        pad = dense < 0
        k = np.maximum(dense, 0)
        if not len(src):                 # no edges: every slot a pad
            src = wsel = np.zeros(1, np.int64)
            w = np.zeros(1, np.float32)
        out = np.stack([np.where(pad, sentinel, src[k]), dense,
                        np.where(pad, wsel[0], wsel[k]),
                        np.where(pad, np.float32(0), w[k]).astype(
                            np.float32).view(np.int32)], -1)
        return out.astype(np.int32)

    live_cm, live_cs = t.cm_src >= 0, t.cs_src >= 0
    cm = slots(t.cm_dense, np.where(live_cm, t.cm_src, M),
               np.where(t.cm_reset, -1, np.maximum(t.cm_src, 0)),
               np.where(live_cm, t.cm_w, np.float32(0)), M)
    cs = slots(t.cs_dense, np.where(live_cs, t.cs_src, M),
               np.maximum(t.cs_src, 0),
               np.where(live_cs, t.cs_w, np.float32(0)), M)
    return {"in_slot": slots(t.in_dense, in_src, in_src, t.in_w, M + E),
            "ex_slot": slots(t.ex_dense, t.ex_src, t.ex_src, t.ex_w, E),
            **distinct_rows(list(cm) + list(cs), M)}


def distinct_rows(rows, sentinel: int) -> Dict[str, np.ndarray]:
    """The closure's and the sinks' rows ([K, 4] slots each, the M model
    entries then the S sinks) grouped by their sequence of (source,
    weight bits), length included: rows equal in it take the same first
    maximum at the same slot, whatever their edge ids and word-time
    sources, so the kernel reduces each distinct row once.
      cx_row [U, Kx, 2]: (source, weight bits) of each distinct row, in
        slot order (past its length: the sentinel, weight 0; never read)
      cx_len [U]: its length;  cx_of [D]: each destination's row
      cx_dst [D, Kx, 2]: (edge id, word-time source) of each
        destination's own slots, read at the winning slot."""
    Kx = max(len(r) for r in rows)
    index: Dict[bytes, int] = {}
    first = []
    of = np.empty(len(rows), np.int32)
    cx_dst = np.zeros((len(rows), Kx, 2), np.int32)
    for d, r in enumerate(rows):
        key = np.ascontiguousarray(r[:, [0, 3]]).tobytes()
        if key not in index:
            index[key] = len(first)
            first.append(r[:, [0, 3]])
        of[d] = index[key]
        cx_dst[d, :len(r)] = r[:, [1, 2]]
    cx_row = np.zeros((len(first), Kx, 2), np.int32)
    cx_row[..., 0] = sentinel
    for u, r in enumerate(first):
        cx_row[u, :len(r)] = r
    return {"cx_row": cx_row,
            "cx_len": np.asarray([len(r) for r in first], np.int32),
            "cx_of": of, "cx_dst": cx_dst}


def _dense_max_argmax(vals: torch.Tensor, dense: torch.Tensor):
    """[B, N] values, [D, K] incoming-edge rows (-1 padded) -> per row and
    destination the maximum and the edge id of the first slot holding it
    (-1 where a pad wins: index -1 reads the appended NEG sentinel)."""
    v = torch.cat([vals, vals.new_full((vals.shape[0], 1), float(NEG))], 1)
    picked = v[:, dense.long()]                          # [B, D, K]
    k = torch.argmax(picked, dim=2, keepdim=True)        # first maximum
    mx = picked.gather(2, k)[..., 0]
    am = dense.expand(vals.shape[0], *dense.shape).gather(2, k.to(
        torch.int64))[..., 0]
    return mx, am.to(torch.int32)


def netscan_plain(carry: Carry, obs: torch.Tensor, t0: torch.Tensor,
                  n_valid: torch.Tensor, beam: torch.Tensor,
                  tb: Dict[str, torch.Tensor]
                  ) -> Tuple[Carry, Dict[str, torch.Tensor]]:
    """The scan as a Python loop of torch ops over frames, on any
    device."""
    alpha, wt, entry, entry_edge, entry_wt = carry
    B, T, E = obs.shape
    n_in, n_ex = tb["in_w"].shape[0], tb["ex_w"].shape[0]
    n_cm, n_cs = tb["cm_w"].shape[0], tb["cs_w"].shape[0]
    S = tb["cs_dense"].shape[0]
    in_m, in_s = tb["in_src_m"].long(), tb["in_src_s"].long()
    in_entry = tb["in_entry"]
    ex_src = tb["ex_src"].long()
    cm_src = tb["cm_src"].long().clamp(min=0)
    cs_src = tb["cs_src"].long().clamp(min=0)
    beam = beam.reshape(B, 1)
    recs = {k: [] for k in RECORDS}
    for i in range(T):
        t = (t0 + 1 + i).to(torch.int32)
        src_val = torch.where(in_entry, entry[:, in_m], alpha[:, in_s])
        src_wt = torch.where(in_entry, entry_wt[:, in_m], wt[:, in_s])
        new_alpha, in_am = _dense_max_argmax(src_val + tb["in_w"],
                                             tb["in_dense"])
        new_wt = src_wt.gather(1, in_am.long().clamp(0, n_in - 1))
        new_alpha = new_alpha + obs[:, i]
        thresh = torch.amax(new_alpha, dim=1, keepdim=True) - beam
        new_alpha = torch.where(new_alpha >= thresh, new_alpha, float(NEG))
        exit_val, ex_am = _dense_max_argmax(
            new_alpha[:, ex_src] + tb["ex_w"], tb["ex_dense"])
        exit_wt = new_wt.gather(1, ex_src[ex_am.long().clamp(0, n_ex - 1)])
        cm_vals = torch.where(tb["cm_src"] < 0, float(NEG),
                              exit_val[:, cm_src] + tb["cm_w"])
        nentry, cm_am = _dense_max_argmax(cm_vals, tb["cm_dense"])
        nentry = torch.where(nentry >= thresh, nentry, float(NEG))
        cm_am_c = cm_am.long().clamp(0, n_cm - 1)
        nentry_wt = torch.where(tb["cm_reset"][cm_am_c], t[:, None],
                                exit_wt.gather(1, cm_src[cm_am_c]))
        if n_cs:
            cs_vals = torch.where(tb["cs_src"] < 0, float(NEG),
                                  exit_val[:, cs_src] + tb["cs_w"])
            sink_val, cs_am = _dense_max_argmax(cs_vals, tb["cs_dense"])
            sink_wt = exit_wt.gather(
                1, cs_src[cs_am.long().clamp(0, n_cs - 1)])
        else:
            sink_val = obs.new_full((B, S), float(NEG))
            cs_am = torch.zeros((B, S), dtype=torch.int32,
                                device=obs.device)
            sink_wt = torch.zeros_like(cs_am)
        for k, v in (("in_am", in_am), ("ex_am", ex_am), ("cm_am", cm_am),
                     ("entry_edge", entry_edge), ("entry_val", entry),
                     ("sink_val", sink_val), ("cs_am", cs_am),
                     ("sink_wt", sink_wt), ("exit_val", exit_val)):
            recs[k].append(v)
        valid = (t <= n_valid)[:, None]
        new = (new_alpha, new_wt, nentry, cm_am_c.to(torch.int32),
               nentry_wt)
        alpha, wt, entry, entry_edge, entry_wt = (
            torch.where(valid, n_, o_) for n_, o_ in zip(
                new, (alpha, wt, entry, entry_edge, entry_wt)))
    out = {}
    for k, (dt, _) in RECORDS.items():
        out[k] = (torch.stack(recs[k], dim=1).to(dt) if T else torch.empty(
            (B, 0, _width(k, E, entry.shape[1], S)), dtype=dt,
            device=obs.device))
    return (alpha, wt, entry, entry_edge, entry_wt), out


def _width(name: str, E: int, M: int, S: int) -> int:
    return {"E": E, "M": M, "S": S}[RECORDS[name][1]]


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of a kernel-G library's entry points."""
    fn = lib.netscan
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 10 + [ctypes.c_void_p] * 6
                       + [ctypes.c_void_p] * 4 + [ctypes.c_void_p] * 10
                       + [ctypes.c_void_p] * 9
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.netscan_smem_bytes.argtypes = [ctypes.c_int] * 7
        lib.netscan_smem_bytes.restype = ctypes.c_longlong
        lib.netscan_scratch_words.argtypes = [ctypes.c_int] * 3
        lib.netscan_scratch_words.restype = ctypes.c_int
    return lib


def _lib():
    return bind(_build.load("netscan"))


def _sizes(tb: Dict[str, torch.Tensor]) -> Dict[str, int]:
    """The network's sizes as the kernel reads them, from the tables'
    shapes (no device work)."""
    return dict(E=tb["in_slot"].shape[0], M=tb["ex_slot"].shape[0],
                D=tb["cx_of"].shape[0], Kin=tb["in_slot"].shape[1],
                Kex=tb["ex_slot"].shape[1], Kx=tb["cx_row"].shape[1],
                U=tb["cx_row"].shape[0], n_cs=tb["cs_w"].shape[0])


def _row_lanes(U: int, Kx: int) -> int:
    """Lanes a distinct row in the warp instance: as many as leave every
    row a group of the warp's 32 (a power of two, no more than the
    slots need); csrc/netscan.cu's lanes_for_rows."""
    G = 1
    while G < 32 and U * 2 * G <= 32 and G < Kx:
        G *= 2
    return G


def plan_instance(tb: Dict[str, torch.Tensor]) -> str:
    """The instance that takes a network, by its sizes alone: "warp"
    within the warp instance's limits (its staged table of the
    destinations' slots and one row's slice in a block's shared memory),
    else "block"."""
    z = _sizes(tb)
    E, M, D, U, Kx = z["E"], z["M"], z["D"], z["U"], z["Kx"]
    G = _row_lanes(U, Kx)
    smem = 8 * D * Kx + 4 * ((6 * E + 4 * M + 6) // 4 * 4)
    fits = (E <= WARP_MAX_E and max(z["Kin"], z["Kex"]) <= WARP_MAX_K
            and M <= WARP_MAX_M and D <= WARP_MAX_D and U <= WARP_MAX_U
            and -(-Kx // G) <= WARP_ROW_SLOTS and smem <= SMEM_MAX)
    return "warp" if fits else "block"


def launch(lib: ctypes.CDLL, carry: Carry, obs: torch.Tensor,
           t0: torch.Tensor, n_valid: torch.Tensor, beam: torch.Tensor,
           tb: Dict[str, torch.Tensor], force_global: bool = False,
           instance: str = "block"
           ) -> Tuple[Carry, Dict[str, torch.Tensor]]:
    """Launch one instance of the kernel of ``lib`` (a bound kernel-G
    library) on CUDA tensors; raises on anything it does not take (the
    warp instance on a network past its limits too).  "warp": a warp a
    row, the tables staged in shared memory.  "block": where a row's
    values, two frames of observations and the tables fit a block's
    shared memory they live there, else in device memory;
    ``force_global`` takes device memory in any case (both paths are
    held to the plain version).  Counts nothing."""
    if instance not in INSTANCES:
        raise ValueError(f"no instance {instance!r}")
    if instance == "warp" and force_global:
        raise ValueError("the warp instance has no device-memory path")
    device = _build.cuda_device(obs)
    if obs.dim() != 3:
        raise ValueError("obs must be [B, T, E]")
    B, T, E = obs.shape
    z = _sizes(tb)
    M, D, U, Kx = z["M"], z["D"], z["U"], z["Kx"]
    S = D - M
    if z["E"] != E or S < 0:
        raise ValueError("tables do not match obs's state count")
    if B * T * max(E, M, S, 1) >= 2 ** 31 or B > 2 ** 31 - 1:
        raise ValueError("block too large for 32-bit offsets")
    for name, dt, shape in (
            ("in_slot", torch.int32, (E, z["Kin"], 4)),
            ("ex_slot", torch.int32, (M, z["Kex"], 4)),
            ("cx_row", torch.int32, (U, Kx, 2)),
            ("cx_len", torch.int32, (U,)), ("cx_of", torch.int32, (D,)),
            ("cx_dst", torch.int32, (D, Kx, 2))):
        _build.require(tb[name], name, dt, shape, device)
    _build.require(obs, "obs", torch.float32, (B, T, E), device)
    for name, t in (("t0", t0), ("n_valid", n_valid)):
        _build.require(t, name, torch.int32, (B,), device)
    _build.require(beam, "beam", torch.float32, (B,), device)
    for name, t, dt, w in zip(
            ("alpha", "wt", "entry", "entry_edge", "entry_wt"), carry,
            (torch.float32, torch.int32, torch.float32, torch.int32,
             torch.int32), (E, E, M, M, M)):
        _build.require(t, name, dt, (B, w), device)
    out_carry = tuple(torch.empty_like(t) for t in carry)
    recs = {k: torch.empty((B, T, _width(k, E, M, S)), dtype=dt,
                           device=device)
            for k, (dt, _) in RECORDS.items()}
    warp = instance == "warp"
    if warp and plan_instance(tb) != "warp":
        raise ValueError("the network is past the warp instance's limits")
    use_smem = warp or not force_global and lib.netscan_smem_bytes(
        E, M, S, z["Kin"], z["Kex"], Kx, U) > 0
    scratch = torch.empty(0 if use_smem else
                          B * lib.netscan_scratch_words(E, M, U),
                          device=device)
    if B == 0:
        return out_carry, recs
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.netscan(
            B, T, E, M, S, z["n_cs"], z["Kin"], z["Kex"], Kx, U,
            *(tb[k].data_ptr() for k in _TABLES),
            obs.data_ptr(), t0.data_ptr(), n_valid.data_ptr(),
            beam.data_ptr(), *(t.data_ptr() for t in carry),
            *(t.data_ptr() for t in out_carry),
            *(recs[k].data_ptr() for k in RECORDS), scratch.data_ptr(),
            int(use_smem), int(warp), stream)
    _build.check(err, "netscan")
    return out_carry, recs


def netscan(carry: Carry, obs: torch.Tensor, t0: torch.Tensor,
            n_valid: torch.Tensor, beam: torch.Tensor,
            tb: Dict[str, torch.Tensor]
            ) -> Tuple[Carry, Dict[str, torch.Tensor]]:
    """One block of frames: CPU tensors take the plain version; CUDA
    tensors launch the instance the network's sizes pick (one launch for
    all T frames), and anything the kernel does not take raises."""
    args = (carry, obs, t0, n_valid, beam, tb)
    if obs.device.type == "cpu":
        return netscan_plain(*args)
    _build.cuda_device(obs)            # raises before any build
    inst = plan_instance(tb)
    out = launch(_lib(), *args, instance=inst)
    global LAUNCHES, WARP_LAUNCHES
    if inst == "warp":
        WARP_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out
