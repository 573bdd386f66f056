#!/usr/bin/env python3
"""Smoke test of phnrec_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the sixteen CUDA kernels from the ten sources in
phnrec_tpu_torch/csrc (one nvcc each, all started together) and holds each against its plain
PyTorch version on the card at its path's shapes: A (fused MLP, float32;
also at row counts that fill no row tile, and timed beside cuBLAS's two
products alone) and A' (fused MLP, bf16 tensor-core passes, 3 and 1) at the
CZ nets, their split paths (A's register-tiled SGEMM, A''s wgmma
products) past the fused widths and at the 3BT / 1BT mergers' shapes,
timed at 128,000 rows, C and
C' (phoneme-loop scan, uniform and ragged), D and D' (backtrack, whole and
committed window, also on the case list of devtools/backtrack_variants.py,
and D timed at the serving History), B (network-Viterbi block), F (LRTrace
scan), G (edge-list network scan), H (its traceback, on a case list of
networks, ties, beams, carried blocks and committed boundaries; its int16
instance on E's records), E (the decode-mode network block), J (the
phoneme-loop forward-backward), K (the training graph's forward-backward)
and K' (its Viterbi alignment).  Then it drives ten paths of the port:

* the batch wav->rec path, once through the CLI on a synthetic package at
  the CZ SpeechDat LCRC shapes (64 files), and times a batch of 1024 x 5 s
  at precision "highest" and at "high", counting the utterances whose
  labels agree;
* phoneme-loop serving on the CZ package: 4 streams x 10 s fed through
  MultiStreamRecognizer.process(), and one of them through
  StreamingRecognizer, each held against the CPU port; then 256 streams x
  61.44 s staged on the card as int16, decoded through
  decode_device_buffer in blocks of 512 frames and finish(), timed at
  "highest" and at "high", and once more with commit_horizon set;
* multi-stream keyword spotting (MultiStreamKWS) on a synthetic package at
  the EN TIMIT LCRC N500 shapes with the keywords greasy/wash: 4 streams x
  10 s fed through process() and held against the CPU port, then 256
  streams x 60 s staged on the card, decoded through decode_device_buffer
  in blocks of 512 frames and timed;
* offline STK-network decoding: the CLI on 64 files of a CZ stkint decode
  package (the generated phoneme loop, kernels G and H), held against the
  CPU port; a timed stkint batch of 256 x 5 s by stages; and 8 EN files
  through the KWS package's process_file_list, whose hits equal the CPU
  port's on the card's log-posteriors;
* stkint decode serving (MultiStreamStkDecode, kernels A, E and H) on the
  CZ stkint loop: 4 streams x 10 s fed through process() and held against
  the CPU port, with and without fixed-lag commits, then 256 streams x
  61.44 s staged on the card, one decode_device_buffer call a block of
  512 frames with the default record horizon, then finish(), timed; and
  the KWS server on two more EN packages, one with a global <InputXform>
  (kernel B), one with 300 keywords (past 1,024 models + states: kernels G
  and F), each held against the CPU port;
* single-stream stkint streaming (StreamingRecognizer, kernels A and G;
  in KWS mode F through DeviceKWSTracker): one CZ stkint stream of 60 s
  in 0.25 s chunks without and with commits, and 30 s of live KWS on the
  EN package with a tracker at each pair of LRTrace's settings, held
  against the CPU port's replay of the card's log-posteriors and sink
  records; kernel F at each setting pair against its plain version;
* the other posterior systems at the CZ widths (3BT, 1BT, 1BT_DCT) and
  the PLP frontend: the 3BT band stack on kernels A and A′ with the band
  index against their plain versions, timed three ways; 16 files a
  system through the CLI held against the CPU port, a timed batch of 256
  x 5 s each, and the 3BT and 1BT batches again at "high" (A′'s band
  stack); the mergers take the split paths in both modes.
* HMM re-estimation (train/, the Reestimator): J, K and K' against their
  plain versions on a case list (ragged n_frames, padded graphs, S 32 to
  6,304, ties); 16 CZ files through the staged CLI (-t par, -s par -t
  post, -s post -t str), labels equal to wf->str's; the posterior route
  (256 x 5 s of the CZ package's log-posteriors, netgen's PDFObsVec HMM
  set, each utterance transcribed by its own labels: two Baum-Welch and
  one Viterbi iteration with update_ml, write_mmf; 8 utterances held to
  the CPU port; the phoneme-loop occupancies of 16 through J) and the GMM
  route (64 CLI par files read back with deltas, a seeded DiagC set of 46
  x 3 x 8 mixtures: Baum-Welch with update_ml, sMBR with update_mmi on 16
  utterances).
* the host-side entry points: the CZ list decode again with up to three
  batches in flight and in the serial order (MLFs equal the cli phase's,
  walls beside its); the CLI's --alize (lines equal labels_to_alize),
  --profile (the five stages) and --trace=DIR (a Chrome trace naming
  kernel A's or C's function); the native host library (built by g++;
  backtrack_batch's native route on the card's History equals the Python
  replay and kernel D); live input (run_live, the CLI's -a) over 20 s of
  the CZ serving package and, in KWS mode with the threshold filter, of
  the EN package, each from a file on the card (lines equal the final
  labels, which equal StreamingRecognizer fed the same chunks and the CPU
  port's run_live replaying the card's log-posteriors; the real-time
  factor and chunks a second), and the CLI's -a in a subprocess reading
  the bytes from a pipe; torch.distributed at world size 1 (NCCL over a
  FileStore, a DeviceMesh with a "data" dimension): DistributedRunner
  over the 64 files with an MLF and a resumed run, aggregate_metrics,
  BatchPipeline(mesh=) and the three servers with mesh= (4 streams x
  10 s, shard_audio on the stkint one) against their unsharded runs, and
  psum_accumulators.
* the last public surface: single-utterance ``posteriors`` of the LCRC,
  3BT, 1BT and 1BT_DCT estimators at the CZ widths (one 5 s utterance,
  "highest" and "high"; kernels A / A', the band index, the split paths)
  held bit for bit to posteriors_batched of the utterance alone and to
  its row of a batch of 4; and the five twins of examples/ through their
  main (batch_decode on 16 x 5 s, streaming_decode on 20 s at 250 ms,
  keyword_spotting on the EN KWS package, multistream_serving on 4 CZ and
  4 EN KWS files with and without --mesh at world size 1, train_gmm_hmm
  for 5 iterations), each held to the path it wraps.

It prints one JSON line of kernel results, each kernel with its launches
on a path of this run and its time beside its bound (the larger of its
bytes over 3.35 TB/s and its operations over the H100's published peak
for their type), the card's name and power limit, and a last line
{"ok": true, "device": {...}}.  Any failed phase raises and the script
exits non-zero; without a CUDA card it exits non-zero before any result.
Imports neither JAX nor phnrec_tpu.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import torch

from phnrec_tpu_torch import precision, synth
from phnrec_tpu_torch.decoder import phnloop
from phnrec_tpu_torch.decoder.stknet import (NEG, OFF_BEAM, DenseKWSScan,
                                             DeviceKWSTracker, NetworkDecoder)
from phnrec_tpu_torch.devtools import (backtrack_variants, scan_variants,
                                       train_turns, trainfb_variants)
from phnrec_tpu_torch.devtools.mlp_variants import cuda_ms
from phnrec_tpu_torch.devtools.netstep_variants import inputs as b_inputs
from phnrec_tpu_torch.devtools.netstep_variants import sm_clock
from phnrec_tpu_torch.io.labels import read_mlf
from phnrec_tpu_torch.io.mmf import parse_mmf, write_mmf
from phnrec_tpu_torch.multistream import (MultiStreamKWS,
                                          MultiStreamRecognizer,
                                          MultiStreamStkDecode)
from phnrec_tpu_torch.ops import (_build, backtrack, lrtrace, mlp_bf16x3,
                                  mlp_fused, netdecode, netscan, netstep,
                                  nettrace, phnloop_fb, phnloop_viterbi,
                                  trainfb)
from phnrec_tpu_torch.pipeline import SpeechRec
from phnrec_tpu_torch.streaming import StreamingRecognizer
from phnrec_tpu_torch.train import (accumulate_utterance_mbr, apply_update,
                                    compile_transcription, make_accumulators,
                                    reference_hmm_ids, update_ml, update_mmi,
                                    viterbi_align)
from phnrec_tpu_torch.train.fb import log_obs, make_obs_tables
from phnrec_tpu_torch.train.graph import build_model_index
from phnrec_tpu_torch.train.loop import Reestimator

CSRC = "phnrec_tpu_torch/csrc/"
SOURCES = ("mlp_fused", "mlp_bf16x3", "phnloop_viterbi", "backtrack",
           "netstep", "lrtrace", "netscan", "nettrace", "netdecode",
           "trainfb")
# name -> the wrapper module, its launch counter, the source, the TPU kernel
KERNELS = {
    "mlp_fused": dict(module=mlp_fused, counter="LAUNCHES",
                      source=CSRC + "mlp_fused.cu",
                      replaces="phnrec_tpu/ops/pallas_mlp.py:175"),
    "mlp_bf16x3": dict(module=mlp_bf16x3, counter="LAUNCHES",
                       source=CSRC + "mlp_bf16x3.cu",
                       replaces="phnrec_tpu/ops/pallas_mlp.py:156"),
    "mlp_fused_wide": dict(module=mlp_fused, counter="WIDE_LAUNCHES",
                           source=CSRC + "mlp_fused.cu",
                           replaces="phnrec_tpu/ops/pallas_mlp.py:175"),
    "mlp_bf16x3_wide": dict(module=mlp_bf16x3, counter="WIDE_LAUNCHES",
                            source=CSRC + "mlp_bf16x3.cu",
                            replaces="phnrec_tpu/ops/pallas_mlp.py:156"),
    "netstep": dict(module=netstep, counter="LAUNCHES",
                    source=CSRC + "netstep.cu",
                    replaces="phnrec_tpu/ops/pallas_netstep.py:231"),
    "phnloop_viterbi": dict(module=phnloop_viterbi, counter="LAUNCHES",
                            source=CSRC + "phnloop_viterbi.cu",
                            replaces="phnrec_tpu/decoder/phnloop.py:79"),
    "phnloop_viterbi_ragged": dict(
        module=phnloop_viterbi, counter="RAGGED_LAUNCHES",
        source=CSRC + "phnloop_viterbi.cu",
        replaces="phnrec_tpu/decoder/phnloop.py:141"),
    "backtrack": dict(module=backtrack, counter="LAUNCHES",
                      source=CSRC + "backtrack.cu",
                      replaces="phnrec_tpu/decoder/phnloop.py:375"),
    "backtrack_committed": dict(
        module=backtrack, counter="COMMITTED_LAUNCHES",
        source=CSRC + "backtrack.cu",
        replaces="phnrec_tpu/decoder/phnloop.py:328"),
    "lrtrace": dict(module=lrtrace, counter="LAUNCHES",
                    source=CSRC + "lrtrace.cu",
                    replaces="phnrec_tpu/decoder/stknet.py:1114"),
    "netscan": dict(module=netscan, counter="LAUNCHES",
                    source=CSRC + "netscan.cu",
                    replaces="phnrec_tpu/decoder/stknet.py:451"),
    "netscan_warp": dict(module=netscan, counter="WARP_LAUNCHES",
                         source=CSRC + "netscan.cu",
                         replaces="phnrec_tpu/decoder/stknet.py:451"),
    "nettrace": dict(module=nettrace, counter="LAUNCHES",
                     source=CSRC + "nettrace.cu",
                     replaces="phnrec_tpu/decoder/stknet.py:668"),
    "netdecode": dict(module=netdecode, counter="LAUNCHES",
                      source=CSRC + "netdecode.cu",
                      replaces="phnrec_tpu/decoder/stknet.py:961"),
    "phnloop_fb": dict(module=phnloop_fb, counter="LAUNCHES",
                       source=CSRC + "trainfb.cu",
                       replaces="phnrec_tpu/decoder/forward_backward.py:44"),
    "phnloop_fb_group": dict(
        module=phnloop_fb, counter="GROUP_LAUNCHES",
        source=CSRC + "trainfb.cu",
        replaces="phnrec_tpu/decoder/forward_backward.py:44"),
    "graph_fb": dict(module=trainfb, counter="LAUNCHES",
                     source=CSRC + "trainfb.cu",
                     replaces="phnrec_tpu/train/fb.py:92"),
    "graph_align": dict(module=trainfb, counter="ALIGN_LAUNCHES",
                        source=CSRC + "trainfb.cu",
                        replaces="phnrec_tpu/train/fb.py:135"),
    "graph_fb_cluster": dict(module=trainfb, counter="CLUSTER_LAUNCHES",
                             source=CSRC + "trainfb.cu",
                             replaces="phnrec_tpu/train/fb.py:92"),
    "graph_align_cluster": dict(module=trainfb,
                                counter="ALIGN_CLUSTER_LAUNCHES",
                                source=CSRC + "trainfb.cu",
                                replaces="phnrec_tpu/train/fb.py:135"),
}
BATCH_KERNELS = ("mlp_fused", "phnloop_viterbi", "backtrack")
KWS_KERNELS = ("mlp_fused", "netstep", "lrtrace")
STK_KERNELS = ("mlp_fused", "netscan_warp", "nettrace")
# kernel G's two instances: a block a row (big networks), a warp a row
G_KERNELS = ("netscan", "netscan_warp")
STK_SERVE_KERNELS = ("mlp_fused", "netdecode", "nettrace")
# the split paths of A and A' (the 3BT / 1BT mergers)
WIDE_KERNELS = ("mlp_fused_wide", "mlp_bf16x3_wide")
# kernels K and K', on a cluster and one block an utterance
GRAPH_KERNELS = ("graph_fb", "graph_align", "graph_fb_cluster",
                 "graph_align_cluster")
# kernel J's two instances: a block an utterance (past 1,024 states), a
# group of warps an utterance
J_KERNELS = ("phnloop_fb", "phnloop_fb_group")
# kernel A against cuBLAS float32: both sum in another order, and fexp is a
# step function of its argument (steps of 2^-20 relative), so outputs differ
# by a few ulp of the sums; probabilities within 2e-5, raw logits within 1e-4.
# Kernel A' with 3 passes is held to the same tolerances.
TOL_SOFTMAX = 2e-5
TOL_LOGITS = 1e-4
# Kernel A' with 1 pass keeps only h_hi of each hidden activation, and
# h_hi = bf16(h) jumps by one bf16 ulp (<= 2^-8 for h < 1) where h crosses a
# rounding midpoint: a last-bit difference in the first GEMM's sum (the
# kernel and cuBLAS sum in another order) then moves a logit by up to
# 2^-8 max|W2|.  The tolerance allows 8 such flips aligned in one output.
# Logits all within d move each probability p by at most p (e^(2d) - 1),
# so probabilities are held element by element to that (plus TOL_SOFTMAX).
ONE_PASS_FLIPS = 8
# The H100 SXM's published peaks: float32 outside
# the tensor cores, bf16 on them, and the memory rate
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
# KWS log-posteriors, CPU port against the card: the frontend GEMMs and
# kernel A sum in another order than the CPU's, and ln amplifies the
# relative error of small posteriors
TOL_KWS_LP = 1e-3
# the same for the phoneme-loop log-posteriors at the CZ shapes
TOL_PHN_LP = 1e-3


_T0 = time.perf_counter()


def phase(name: str, **fields) -> None:
    """One JSON line of a phase's results, with the script's seconds so
    far (``t_s``)."""
    print(json.dumps({"phase": name, **fields,
                      "t_s": round(time.perf_counter() - _T0, 1)}),
          flush=True)


def g_counter(dec) -> str:
    """The counter of the kernel-G instance a network's sizes pick."""
    return ("netscan_warp" if netscan.plan_instance(dec.edge_tables("cpu"))
            == "warp" else "netscan")


def reset_counts(names) -> None:
    for k in names:
        setattr(KERNELS[k]["module"], KERNELS[k]["counter"], 0)


def read_counts(names) -> dict:
    return {k: getattr(KERNELS[k]["module"], KERNELS[k]["counter"])
            for k in names}


def bound(n_bytes: float, ops: float, peak_ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over their type's peak rate."""
    t_b, t_o = n_bytes / PEAK_BYTES * 1e3, ops / peak_ops * 1e3
    return dict(bound_ms=max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o else "operations",
                library_ms=None)


def mlp_work(net, n: int, passes: int = 0):
    """(bytes, multiply-add operations) of one net over n rows: x read and
    the output written once, the weights read once (float32, or bf16 hi
    and lo), two operations per multiply-add per pass (passes 0 is kernel
    A's float32)."""
    macs = n * (net.n_inp * net.n_hid + net.n_hid * net.n_out)
    w = net.n_inp * net.n_hid + net.n_hid * net.n_out
    n_bytes = 4 * (n * (net.n_inp + net.n_out) + 2 * net.n_inp + net.n_hid
                   + net.n_out) + 4 * w
    return n_bytes, 2 * macs * max(passes, 1)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def clocks(fn, ms: float, frames: int) -> dict:
    """The SM clock under load while ``fn`` runs, and ``ms`` in clocks a
    frame of a scan over ``frames`` frames."""
    mhz = sm_clock(fn, max(ms, 0.2))
    return dict(sm_clock_mhz=mhz,
                clocks_a_frame=ms * 1e-3 * mhz * 1e6 / frames)


def _mlp_inputs(sr, dev, n: int):
    """The package's three nets and seeded inputs of n rows for each,
    scaled so the normalised inputs are unit normal."""
    rng = np.random.default_rng(3)
    nets = {"band0": sr.estimator.band[0], "band1": sr.estimator.band[1],
            "merger": sr.estimator.merger}
    xs = {}
    for name, net in nets.items():
        z = torch.from_numpy(rng.standard_normal((n, net.n_inp), np.float32))
        xs[name] = (z.to(dev) / net.dev + net.mean).contiguous()
    return nets, xs


def sgemm_pair_ms(x, net) -> float:
    """The two float32 products of a net alone (cuBLAS, no norm, bias or
    activation, the hidden tensor through device memory): not the kernel's
    function and never called by the port, but the share of the FP32 peak
    that the library reaches on products this narrow."""
    return cuda_ms(lambda: torch.matmul(torch.matmul(x, net.w1), net.w2))


# row counts that are a multiple of no row tile: one row, less than a tile,
# and the timed size plus a ragged last tile
RAGGED_ROWS = (1, 37, 65536 + 37)


def check_mlp(sr, dev, shapes: str = "cz") -> dict:
    """Kernel A against its plain version at a package's three nets: timed
    at 65,536 rows, held to the same tolerances at the ragged row counts
    (band0 and the merger; band0 alone at the EN shapes), and band0 timed
    at 512 rows, the size of a single stream's call."""
    n = 65536
    nets, xs_all = _mlp_inputs(sr, dev, max(RAGGED_ROWS))
    xs = {k: v[:n] for k, v in xs_all.items()}
    worst, ms, plain_ms, work = 0.0, 0.0, 0.0, [0, 0]
    per_net = {}
    for name in ("band0", "merger") if shapes == "cz" else ("band0",):
        net = nets[name]
        for rows in RAGGED_ROWS:
            args = (xs_all[name][:rows], net.mean, net.dev, net.w1, net.b1,
                    net.w2, net.b2)
            for fast, smx in ((True, True), (False, False)):
                kw = dict(fast=fast, apply_softmax=smx)
                got = mlp_fused.mlp_forward(*args, **kw)
                want = mlp_fused.mlp_forward_plain(*args, **kw)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                tol = TOL_SOFTMAX if smx else TOL_LOGITS
                phase("mlp_fused_ragged", shapes=shapes, net=name, rows=rows,
                      fast=fast, softmax=smx, max_abs_err=err, tol=tol)
                if got.shape != want.shape or \
                        not torch.isfinite(got).all() or not err <= tol:
                    raise AssertionError(
                        f"mlp_fused {name} rows={rows} fast={fast} "
                        f"softmax={smx}: err {err} > {tol}")
                worst = max(worst, err)
    b0 = nets["band0"]
    small = (xs["band0"][:512], b0.mean, b0.dev, b0.w1, b0.b1, b0.w2, b0.b2)
    phase("mlp_fused_small", shapes=shapes, net="band0", rows=512,
          small_rows_ms=cuda_ms(lambda: mlp_fused.mlp_forward(*small)))
    for name, net in nets.items():
        args = (xs[name], net.mean, net.dev, net.w1, net.b1, net.w2, net.b2)
        pair_ms = sgemm_pair_ms(xs[name], net)
        cases = [(True, True), (False, True)] + (
            [(True, False)] if name == "band0" else [])
        for fast, smx in cases:
            kw = dict(fast=fast, apply_softmax=smx)
            got = mlp_fused.mlp_forward(*args, **kw)
            want = mlp_fused.mlp_forward_plain(*args, **kw)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise AssertionError(f"mlp_fused {name}: non-finite output")
            err = float((got - want).abs().max())
            tol = TOL_SOFTMAX if smx else TOL_LOGITS
            t_k = cuda_ms(lambda: mlp_fused.mlp_forward(*args, **kw))
            t_p = cuda_ms(lambda: mlp_fused.mlp_forward_plain(*args, **kw))
            phase("mlp_fused", shapes=shapes, net=name, rows=n,
                  shape=[net.n_inp, net.n_hid, net.n_out], fast=fast,
                  softmax=smx, max_abs_err=err, tol=tol, ms=t_k, plain_ms=t_p,
                  sgemm_pair_ms=pair_ms)
            if not err <= tol:
                raise AssertionError(f"mlp_fused {name} fast={fast} "
                                     f"softmax={smx}: err {err} > {tol}")
            worst = max(worst, err)
            per_net[(name, fast, smx)] = t_k
            if fast and smx:       # the main path's setting
                ms += t_k
                plain_ms += t_p
                b, o = mlp_work(net, n)
                work[0] += b
                work[1] += o
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                **bound(work[0], work[1], PEAK_FP32), per_net=per_net)


# (n_inp, n_hid, n_out) that no package has: n_hid of no multiple of 4 (rows
# of W1 then start off 16-byte boundaries and are copied 4 bytes at a time),
# one slab and one chunk only, every count of columns a lane, the widest
# input and output the kernel takes
ODD_SHAPES = ((7, 6, 4), (20, 16, 9), (55, 33, 12), (165, 70, 138),
              (39, 1501, 183), (100, 257, 256), (480, 130, 200))


# row counts of the odd-width cases: the 64-row tile (one block, a few) and
# the 128-row tile
ODD_ROWS = (5, 200, 9000)


def _odd_nets(dev, shapes=ODD_SHAPES):
    """Seeded nets of ``shapes``, with unit-variance pre-activations and
    logits as check_mlp's: (shape, (mean, dev, w1, b1, w2, b2))."""
    rng = np.random.default_rng(6)

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    for n_inp, n_hid, n_out in shapes:
        net = (t(n_inp), t(n_inp).abs() + 0.5,
               t(n_inp, n_hid, scale=n_inp ** -0.5), t(n_hid, scale=0.1),
               t(n_hid, n_out, scale=n_hid ** -0.5), t(n_out, scale=0.1))
        yield (n_inp, n_hid, n_out), net, [t(rows, n_inp)
                                           for rows in ODD_ROWS]


def check_mlp_odd_shapes(dev) -> None:
    """Kernel A against its plain version on seeded nets of odd widths, at
    row counts that take the 64-row and the 128-row tile."""
    worst = {True: 0.0, False: 0.0}
    for (n_inp, n_hid, n_out), net, xs in _odd_nets(dev):
        for rows, x in zip(ODD_ROWS, xs):
            for fast, smx in ((True, True), (False, False)):
                kw = dict(fast=fast, apply_softmax=smx)
                got = mlp_fused.mlp_forward(x, *net, **kw)
                want = mlp_fused.mlp_forward_plain(x, *net, **kw)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                tol = TOL_SOFTMAX if smx else TOL_LOGITS
                if not torch.isfinite(got).all() or not err <= tol:
                    raise AssertionError(
                        f"mlp_fused {n_inp}->{n_hid}->{n_out} rows={rows} "
                        f"fast={fast} softmax={smx}: err {err} > {tol}")
                worst[smx] = max(worst[smx], err)
    phase("mlp_fused_odd", shapes=ODD_SHAPES, rows=ODD_ROWS,
          max_abs_err_softmax=worst[True], tol_softmax=TOL_SOFTMAX,
          max_abs_err_logits=worst[False], tol_logits=TOL_LOGITS)


# nets past the fused kernels' widths (n_inp 480, n_out 256): the split
# paths of kernels A and A'
WIDE_SHAPES = ((500, 257, 138), (165, 200, 300), (500, 1500, 300),
               (600, 100, 200))
# the 3BT and 1BT mergers (cell 8: 13 or 15 band nets of 138 outputs in),
# checked and timed at the rows of a batch of 256 x 5 s
MERGER_SHAPES = ((1794, 1500, 138), (2070, 1500, 138))
MERGER_ROWS = 128000


def _wide_net(dev, shape, seed: int):
    """A seeded net of ``shape`` as _odd_nets makes them, with its bf16
    halves: a namespace of mlp_work's and bf16_products_ms's fields."""
    n_inp, n_hid, n_out = shape
    g = torch.Generator(device=dev).manual_seed(seed)

    def t(*sh, scale=1.0):
        return torch.randn(sh, generator=g, device=dev) * scale

    net = SimpleNamespace(
        n_inp=n_inp, n_hid=n_hid, n_out=n_out, mean=t(n_inp),
        dev=t(n_inp).abs() + 0.5, w1=t(n_inp, n_hid, scale=n_inp ** -0.5),
        b1=t(n_hid, scale=0.1), w2=t(n_hid, n_out, scale=n_hid ** -0.5),
        b2=t(n_out, scale=0.1))
    net.w1_hi, net.w1_lo, net.w2_hi, net.w2_lo = mlp_bf16x3.split_weights(
        net.w1, net.w2)
    return net, g


def _wide_args(net, x, passes: int):
    if not passes:
        return (x, net.mean, net.dev, net.w1, net.b1, net.w2, net.b2)
    return (x, net.mean, net.dev, net.w1_hi, net.w1_lo, net.b1, net.w2_hi,
            net.w2_lo, net.b2)


def _wide_case(what: str, net, x, fast: bool, smx: bool, worst: dict):
    """Kernel A and A' (3 and 1 passes) against their plain versions on one
    input; the worst errors by kernel and output kind into ``worst``."""
    kw = dict(fast=fast, apply_softmax=smx)
    got = mlp_fused.mlp_forward(*_wide_args(net, x, 0), **kw)
    want = mlp_fused.mlp_forward_plain(*_wide_args(net, x, 0), **kw)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    tol = TOL_SOFTMAX if smx else TOL_LOGITS
    if got.shape != want.shape or not torch.isfinite(got).all() or \
            not err <= tol:
        raise AssertionError(f"mlp_fused wide {what} fast={fast} "
                             f"softmax={smx}: err {err} > {tol}")
    key = f"A_{'softmax' if smx else 'logits'}"
    worst[key] = max(worst.get(key, 0.0), err)
    del got, want
    for passes in (3, 1):
        err, _, over, _ = _bf16x3_case(f"wide {what}",
                                       _wide_args(net, x, passes), net.w2,
                                       fast, smx, passes)
        key = f"A'_passes{passes}_{'softmax' if smx else 'logits'}"
        worst[key] = max(worst.get(key, 0.0), err)
        worst[key + "_over_tol"] = max(worst.get(key + "_over_tol", 0.0),
                                       over)


def wide_work(net, n: int, passes: int = 0):
    """mlp_work plus the split path's hidden tensor written and read once
    as float32 (for A', its bf16 hi and lo halves: the same bytes)."""
    n_bytes, ops = mlp_work(net, n, passes)
    return n_bytes + 2 * 4 * n * net.n_hid, ops


def check_mlp_wide(dev) -> dict:
    """Kernels A and A' (3 and 1 passes) against their plain versions on
    seeded nets of WIDE_SHAPES and MERGER_SHAPES at ODD_ROWS (the mergers
    also at MERGER_ROWS + 37), the tolerances of the fused kernels; then
    each merger shape timed at MERGER_ROWS (and the widest WIDE_SHAPES net
    at 65,536 rows) beside its plain version and the library's bare
    products (sgemm_pair_ms for A, bf16_products_ms for A').  Returns the
    kernels line's fields of both split paths at the 3BT merger."""
    worst = {}
    for i, shape in enumerate(WIDE_SHAPES + MERGER_SHAPES):
        net, g = _wide_net(dev, shape, 60 + i)
        rows = ODD_ROWS + ((MERGER_ROWS + 37,) if shape in MERGER_SHAPES
                           else ())
        for n in rows:
            x = torch.randn((n, shape[0]), generator=g, device=dev)
            for fast, smx in ((True, True), (False, False)):
                _wide_case(f"{shape} rows={n}", net, x, fast, smx, worst)
            del x
    phase("mlp_wide", shapes=WIDE_SHAPES + MERGER_SHAPES, rows=ODD_ROWS,
          merger_rows=MERGER_ROWS + 37, max_abs_err=worst,
          tol_softmax=TOL_SOFTMAX, tol_logits=TOL_LOGITS)

    out = {}
    for shape, n in ((WIDE_SHAPES[2], 65536),
                     *((s, MERGER_ROWS) for s in MERGER_SHAPES)):
        net, g = _wide_net(dev, shape, 70)
        x = torch.randn((n, shape[0]), generator=g, device=dev)
        rec = dict(shape=list(shape), rows=n)
        for name, passes in (("A", 0), ("A3", 3), ("A1", 1)):
            args = _wide_args(net, x, passes)
            if passes:
                kw = dict(passes=passes)
                fn = lambda: mlp_bf16x3.mlp_forward_bf16x3(*args, **kw)
                plain = lambda: mlp_bf16x3.mlp_forward_bf16x3_plain(*args,
                                                                    **kw)
                lib = bf16_products_ms(x, net, passes)
            else:
                fn = lambda: mlp_fused.mlp_forward(*args)
                plain = lambda: mlp_fused.mlp_forward_plain(*args)
                lib = sgemm_pair_ms(x, net)
            b, o = wide_work(net, n, passes)
            t_k = cuda_ms(fn)
            rec[name] = dict(ms=t_k, held_ms=scan_variants.held_ms(fn, 5),
                             plain_ms=cuda_ms(plain, iters=3, warmup=1),
                             products_ms=lib,
                             bound=bound(b, o,
                                         PEAK_BF16 if passes else PEAK_FP32))
            rec[name]["share_of_bound"] = rec[name]["bound"]["bound_ms"] / t_k
        phase("mlp_wide_timed", **rec)
        if shape == MERGER_SHAPES[0]:
            for name, key, err, lib in (
                    ("mlp_fused_wide", "A", "A_softmax", "sgemm_pair_ms"),
                    ("mlp_bf16x3_wide", "A3", "A'_passes3_softmax",
                     "bf16_products_ms")):
                r = rec[key]
                out[name] = dict(
                    max_abs_err=worst[err], ms=r["ms"], held_ms=r["held_ms"],
                    plain_ms=r["plain_ms"], **r["bound"],
                    shape=f"{n} rows x {shape[0]}->{shape[1]}->{shape[2]}")
                out[name][lib] = r["products_ms"]
        del x
    return out


def bf16x3_limit(want, w2, smx: bool, passes: int):
    """Kernel A''s tolerance against its plain version: (as printed, the
    element-wise limit).  3 passes: kernel A's; 1 pass: ONE_PASS_FLIPS
    flips of max|W2| on the logits, p (e^(2d) - 1) + TOL_SOFTMAX on each
    probability."""
    tol_a = TOL_SOFTMAX if smx else TOL_LOGITS
    if passes == 3:
        return tol_a, tol_a
    flip = 2.0 ** -8 * float(w2.abs().max())
    if not smx:
        return ONE_PASS_FLIPS * flip, ONE_PASS_FLIPS * flip
    rel = math.expm1(2 * ONE_PASS_FLIPS * flip)
    return f"p * {rel} + {TOL_SOFTMAX}", want * rel + TOL_SOFTMAX


def _bf16x3_case(what: str, args, w2, fast: bool, smx: bool, passes: int):
    """Kernel A' and its plain version on the same inputs: (max abs error,
    its tolerance, the error over the limit at its worst element); raises
    on a non-finite output or an error past the limit."""
    kw = dict(fast=fast, apply_softmax=smx, passes=passes)
    got = mlp_bf16x3.mlp_forward_bf16x3(*args, **kw)
    want = mlp_bf16x3.mlp_forward_bf16x3_plain(*args, **kw)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    err = float(diff.max())
    tol, lim = bf16x3_limit(want, w2, smx, passes)
    if got.shape != want.shape or not torch.isfinite(got).all() or \
            not bool((diff <= lim).all()):
        raise AssertionError(f"mlp_bf16x3 {what} passes={passes} fast={fast} "
                             f"softmax={smx}: err {err} above {tol}")
    return err, tol, float((diff / lim).max()), diff


def bf16_products_ms(x, net, passes: int) -> float:
    """cuBLAS's bare bf16 products of a net at the padded shapes (3 a layer
    at 3 passes, 1 at 1; bf16 out; no norm, split, bias or activation, the
    hidden tensor through device memory): not the kernel's function and
    never called by the port, but the share of the bf16 peak that the
    library reaches on products this narrow."""
    (kp, hp), n = net.w1_hi.shape, x.shape[0]
    a1 = torch.zeros((n, kp), dtype=torch.bfloat16, device=x.device)
    a2 = torch.zeros((n, hp), dtype=torch.bfloat16, device=x.device)

    def run():
        for a, bh, bl in ((a1, net.w1_hi, net.w1_lo),
                          (a2, net.w2_hi, net.w2_lo)):
            torch.matmul(a, bh)
            if passes == 3:
                torch.matmul(a, bl)
                torch.matmul(a, bh)
    return cuda_ms(run)


def _band_single(st, x, b: int, passes: int):
    """Band b of a BandStack through the single net's kernel (A or A′)."""
    if passes:
        return mlp_bf16x3.mlp_forward_bf16x3(
            x[b], st.mean[b], st.dev[b], st.w1_hi[b], st.w1_lo[b], st.b1[b],
            st.w2_hi[b], st.w2_lo[b], st.b2[b], passes=passes)
    return mlp_fused.mlp_forward(x[b], st.mean[b], st.dev[b], st.w1[b],
                                 st.b1[b], st.w2[b], st.b2[b])


def _band_library(st, x, passes: int):
    """The stack's two products as torch.bmm (no norm, bias or
    activation; the hidden tensor through device memory): float32 for A,
    bf16 hi x hi (and the two cross passes at 3) for A′.  Timed beside
    the kernel, never called by the port."""
    if not passes:
        return lambda: torch.bmm(torch.bmm(x, st.w1), st.w2)
    kp, hp = st.w1_hi.shape[1:]
    a1 = torch.zeros((st.n_bands, x.shape[1], kp), dtype=torch.bfloat16,
                     device=x.device)
    a2 = torch.zeros((st.n_bands, x.shape[1], hp), dtype=torch.bfloat16,
                     device=x.device)

    def run():
        for a, bh, bl in ((a1, st.w1_hi, st.w1_lo), (a2, st.w2_hi,
                                                     st.w2_lo)):
            torch.bmm(a, bh)
            if passes == 3:
                torch.bmm(a, bl)
                torch.bmm(a, bh)
    return run


# the band stack's row counts: a streaming block of 128 rows for 1 and 64
# streams, and the batch of 256 x 500 frames
BAND_ROWS = (128, 128 * 64, 256 * 500)


def check_bands(tsr, dev) -> dict:
    """Kernels A and A′ (3 passes) with the band index on a 3BT package's
    band stack (13 nets of 31->1500->138): held to their plain versions
    (the single net's, band by band) at each of BAND_ROWS, and the stack
    timed three ways with the card held while the host enqueues
    (scan_variants.held_ms: at a streaming block a launch is shorter than
    its wrapper's host work): one band-indexed launch, one launch a band,
    and the two torch.bmm products (the library).  Returns per kernel the
    batch shape's numbers for the kernels line."""
    st = tsr.estimator.bands
    nb, out = st.n_bands, {}
    rng = np.random.default_rng(31)
    mode = precision.get_mode()
    for name, passes, tol in (("mlp_fused", 0, TOL_SOFTMAX),
                              ("mlp_bf16x3", 3, TOL_SOFTMAX)):
        precision.set_mode("high" if passes else "highest")
        mod = mlp_bf16x3 if passes else mlp_fused
        for rows in BAND_ROWS:
            z = rng.standard_normal((nb, rows, st.n_inp), np.float32)
            x = (torch.from_numpy(z).to(dev) / st.dev[:, None]
                 + st.mean[:, None]).contiguous()
            before = mod.BAND_LAUNCHES
            got = st(x)
            want = st(x, plain=True)
            per = torch.stack([_band_single(st, x, b, passes)
                               for b in range(nb)])
            torch.cuda.synchronize()
            if mod.BAND_LAUNCHES != before + 1:
                raise AssertionError(f"{name}: the band stack took "
                                     f"{mod.BAND_LAUNCHES - before} launches")
            err = float((got - want).abs().max())
            rec = dict(kernel=name, passes=passes, bands=nb, rows=rows,
                       max_abs_err=err, tol=tol,
                       per_band_max_abs_diff=float((got - per).abs().max()),
                       ms=scan_variants.held_ms(lambda: st(x)),
                       per_band_ms=scan_variants.held_ms(lambda: [
                           _band_single(st, x, b, passes)
                           for b in range(nb)]),
                       library_ms=scan_variants.held_ms(
                           _band_library(st, x, passes)),
                       plain_ms=cuda_ms(lambda: st(x, plain=True), iters=2,
                                        warmup=1))
            phase("traps_band_cases", **rec)
            if not torch.isfinite(got).all() or not err <= tol:
                raise AssertionError(f"{name} bands rows={rows}: err {err}")
            if rows == BAND_ROWS[-1]:
                b_, o_ = mlp_work(st, rows * nb, passes)
                out[name] = dict(
                    max_abs_err=err, ms=rec["ms"], plain_ms=rec["plain_ms"],
                    per_band_ms=rec["per_band_ms"], shape=f"{nb} x {rows} "
                    f"rows x {st.n_inp}->{st.n_hid}->{st.n_out}",
                    **bound(b_ + 4 * (nb - 1) * (
                        st.n_inp * st.n_hid + st.n_hid * st.n_out),
                        o_, PEAK_BF16 if passes else PEAK_FP32),
                    library_ms_bmm=rec["library_ms"])
    precision.set_mode(mode)
    return out


def check_mlp_bf16x3(sr, dev, a_ms: dict) -> dict:
    """Kernel A' against its plain version at the CZ nets, 65,536 rows,
    passes 3 and 1, fast and exact exp, softmax and raw logits, with kernel
    A's time at the same rows and cuBLAS's bare bf16 products beside it;
    then at the ragged row counts (band0 and the merger), band0 timed at
    512 rows, and the odd widths, both pass counts."""
    n = 65536
    nets, xs_all = _mlp_inputs(sr, dev, max(RAGGED_ROWS))
    xs = {k: v[:n] for k, v in xs_all.items()}
    out, work = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0), [0, 0]

    def args_of(net, x):
        return (x, net.mean, net.dev, net.w1_hi, net.w1_lo, net.b1,
                net.w2_hi, net.w2_lo, net.b2)

    for name, net in nets.items():
        args = args_of(net, xs[name])
        for passes in (3, 1):
            products_ms = bf16_products_ms(xs[name], net, passes)
            for fast, smx in ((True, True), (False, True), (True, False)):
                kw = dict(fast=fast, apply_softmax=smx, passes=passes)
                err, tol, over, diff = _bf16x3_case(name, args, net.w2, fast,
                                                    smx, passes)
                t_k = cuda_ms(lambda: mlp_bf16x3.mlp_forward_bf16x3(
                    *args, **kw))
                t_p = cuda_ms(lambda: mlp_bf16x3.mlp_forward_bf16x3_plain(
                    *args, **kw))
                phase("mlp_bf16x3", net=name, rows=n, passes=passes,
                      shape=[net.n_inp, net.n_hid, net.n_out], fast=fast,
                      softmax=smx, max_abs_err=err, tol=tol,
                      worst_err_over_tol=over,
                      share_above_kernel_a_tol=float(
                          (diff > (TOL_SOFTMAX if smx else TOL_LOGITS))
                          .float().mean()),
                      ms=t_k, plain_ms=t_p, bf16_products_ms=products_ms,
                      kernel_a_ms=a_ms.get((name, fast, smx)))
                if passes == 3:
                    out["max_abs_err"] = max(out["max_abs_err"], err)
                    if fast and smx:       # the main path's setting
                        out["ms"] += t_k
                        out["plain_ms"] += t_p
                        b, o = mlp_work(net, n, passes)
                        work[0] += b
                        work[1] += o
    for name in ("band0", "merger"):
        net = nets[name]
        for rows in RAGGED_ROWS:
            for passes in (3, 1):
                for fast, smx in ((True, True), (False, False)):
                    err, tol, over, _ = _bf16x3_case(
                        f"{name} rows={rows}",
                        args_of(net, xs_all[name][:rows]), net.w2, fast, smx,
                        passes)
                    phase("mlp_bf16x3_ragged", net=name, rows=rows,
                          passes=passes, fast=fast, softmax=smx,
                          max_abs_err=err, tol=tol, worst_err_over_tol=over)
    small = args_of(nets["band0"], xs["band0"][:512])
    phase("mlp_bf16x3_small", net="band0", rows=512, small_rows_ms={
        p: cuda_ms(lambda: mlp_bf16x3.mlp_forward_bf16x3(*small, passes=p))
        for p in (3, 1)})
    worst = {}
    for shape, (mean, dv, w1, b1, w2, b2), xs_odd in _odd_nets(dev):
        halves = mlp_bf16x3.split_weights(w1, w2)
        for rows, x in zip(ODD_ROWS, xs_odd):
            args = (x, mean, dv, halves[0], halves[1], b1, halves[2],
                    halves[3], b2)
            for passes in (3, 1):
                for fast, smx in ((True, True), (False, False)):
                    err, _, over, _ = _bf16x3_case(
                        f"{shape} rows={rows}", args, w2, fast, smx, passes)
                    key = f"passes{passes}_{'softmax' if smx else 'logits'}"
                    worst[key] = max(worst.get(key, 0.0), err)
                    worst[key + "_over_tol"] = max(
                        worst.get(key + "_over_tol", 0.0), over)
    phase("mlp_bf16x3_odd", shapes=ODD_SHAPES, rows=ODD_ROWS,
          max_abs_err=worst)
    return {**out, **bound(work[0], work[1], PEAK_BF16)}


def _scan_work(n_rows: int, P: int, S: int, D: int, B: int) -> tuple:
    """(bytes, operations) of a scan over n_rows live (frame, utterance)
    pairs: each live row's log-posteriors read and its History record (9
    bytes) written once, the carry read and written once; per row and
    phoneme S states of 2 adds, a compare and an add, and the argmax's
    compare."""
    n_bytes = n_rows * (4 * D + 9) + 2 * 2 * 4 * P * (S + 1) * B
    return n_bytes, n_rows * P * (4 * S + 1)


def _walk_work(count: torch.Tensor, smax: int, start_bytes: int,
               extra_inputs: int) -> tuple:
    """(bytes, operations) of a backtrack: each hop reads one History
    record (9 bytes); every slot of the output is written once; n_frames
    and ``extra_inputs`` more [B] int32 inputs are read."""
    B = count.shape[0]
    hops = int(count.sum())
    n_bytes = hops * 9 + B * 4 * (2 + extra_inputs) + \
        B * smax * (1 + start_bytes + 4)
    return n_bytes, hops * 4


def check_viterbi_backtrack(dev):
    """Kernels C and D against their plain versions: bit-equal."""
    P, S, B, T = 46, 3, 256, 500
    rng = np.random.default_rng(4)
    spec = phnloop.PhnLoopSpec(n_phonemes=P, n_states=S, w_penalty=-4.6875)
    lp = torch.from_numpy(np.log(rng.dirichlet(np.ones(P * S), size=(B, T)))
                          .astype(np.float32)).to(dev)
    args = (spec.n_phonemes, spec.n_states, spec.w_penalty,
            spec.log_tr_curr, spec.log_tr_next)
    carry = phnloop.init_carry(spec, B, dev)
    ck, hk = phnloop_viterbi.viterbi_block(carry, lp, 0, *args)
    cp, hp = phnloop_viterbi.viterbi_block_plain(carry, lp, 0, *args)
    # the same scan in two blocks, the carry passed through with t0
    c1, h1 = phnloop_viterbi.viterbi_block(carry, lp[:, :200].contiguous(),
                                           0, *args)
    c2, h2 = phnloop_viterbi.viterbi_block(c1, lp[:, 200:].contiguous(),
                                           200, *args)
    torch.cuda.synchronize()
    for a, b, what in [*zip(hk, hp, ("max_phn", "ent", "alpha")),
                       *zip(ck, cp, ("carry alphas", "carry ent")),
                       *zip(hk, (torch.cat([x, y]) for x, y in zip(h1, h2)),
                            ("2-block max_phn", "2-block ent",
                             "2-block alpha")),
                       *zip(ck, c2, ("2-block alphas", "2-block ent"))]:
        if not torch.equal(a, b):
            raise AssertionError(f"phnloop_viterbi: {what} differs")
    t_k = cuda_ms(lambda: phnloop_viterbi.viterbi_block(carry, lp, 0, *args))
    t_p = cuda_ms(lambda: phnloop_viterbi.viterbi_block_plain(
        carry, lp, 0, *args), iters=2, warmup=1)
    clk = clocks(lambda: phnloop_viterbi.viterbi_block(carry, lp, 0, *args),
                 t_k, T)
    phase("phnloop_viterbi", P=P, S=S, B=B, T=T, bit_equal=True, ms=t_k,
          plain_ms=t_p, **clk)
    vit = dict(max_abs_err=0.0, ms=t_k, plain_ms=t_p,
               **bound(*_scan_work(B * T, P, S, P * S, B), PEAK_FP32), **clk)

    n_frames = torch.from_numpy(rng.integers(S, T + 1, size=B)
                                .astype(np.int32)).to(dev)
    smax = phnloop.max_segments(spec, T)
    sk = backtrack.backtrack(*hk, n_frames, smax)
    sp = backtrack.backtrack_plain(*hk, n_frames, smax)
    torch.cuda.synchronize()
    for a, b, what in zip(sk, sp, ("count", "phn", "start", "alpha_end")):
        if not torch.equal(a, b):
            raise AssertionError(f"backtrack: {what} differs")
    walk = _walk_times(lambda: backtrack.backtrack(*hk, n_frames, smax),
                       lambda: backtrack.backtrack_plain(*hk, n_frames, smax),
                       sk[0])
    phase("backtrack", T=T, B=B, smax=smax, equal=True, **walk)
    return vit, dict(max_abs_err=0.0, **walk,
                     **bound(*_walk_work(sk[0], smax, 2, 0), PEAK_FP32))


def check_ragged_committed(dev):
    """Kernels C' and D' against their plain versions at B=256, T=512:
    C' with uneven t0 and n_valid (some rows dead, some whole) from a
    carry one ragged block in, carry and valid History rows bit-equal,
    and C' with uniform rows equal to C; D' on a retained window of a
    longer scan with uneven frame0 and row_offset, every field equal, and
    D' with both 0 equal to D."""
    P, S, B, T = 46, 3, 256, 512
    rng = np.random.default_rng(5)
    spec = phnloop.PhnLoopSpec(n_phonemes=P, n_states=S, w_penalty=-4.6875)
    args = (spec.n_phonemes, spec.n_states, spec.w_penalty,
            spec.log_tr_curr, spec.log_tr_next)

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
    carry, _ = phnloop_viterbi.viterbi_block_ragged(
        phnloop.init_carry(spec, B, dev), lp0, i32(t0), i32(nv0), *args)
    rargs = (carry, lp, i32(t0 + nv0), i32(nv), *args)
    ck, hk = phnloop_viterbi.viterbi_block_ragged(*rargs)
    cp, hp = phnloop_viterbi.viterbi_block_ragged_plain(*rargs)
    uk = phnloop_viterbi.viterbi_block_ragged(
        carry, lp, i32(np.full(B, 77)), i32(np.full(B, T)), *args)
    uc = phnloop_viterbi.viterbi_block(carry, lp, 77, *args)
    torch.cuda.synchronize()
    valid = torch.arange(T, device=dev)[:, None] < i32(nv)[None, :]
    checks = {f"carry {w}": torch.equal(a, b)
              for a, b, w in zip(ck, cp, ("alphas", "ent"))}
    checks.update({f"valid {w}": _live_equal(a, b, valid)
                   for a, b, w in zip(hk, hp, ("max_phn", "ent", "alpha"))})
    checks["uniform rows == kernel C"] = all(
        torch.equal(a, b) for x, y in zip(uk, uc) for a, b in zip(x, y))
    t_k = cuda_ms(lambda: phnloop_viterbi.viterbi_block_ragged(*rargs))
    t_p = cuda_ms(lambda: phnloop_viterbi.viterbi_block_ragged_plain(
        *rargs), iters=2, warmup=1)
    clk = clocks(lambda: phnloop_viterbi.viterbi_block_ragged(*rargs), t_k,
                 T)
    phase("phnloop_viterbi_ragged", P=P, S=S, B=B, T=T,
          live_rows=int(nv.sum()), bit_equal=checks, ms=t_k, plain_ms=t_p,
          **clk)
    if not all(checks.values()):
        raise AssertionError(f"phnloop_viterbi_ragged: {checks}")
    ragged = dict(max_abs_err=0.0, ms=t_k, plain_ms=t_p,
                  **bound(*_scan_work(int(nv.sum()), P, S, P * S, B),
                          PEAK_FP32), **clk)

    # a retained window: row i of stream b is global frame ro[b] + i of a
    # scan from frame 0 (entry frames global)
    full = T + 160
    _, hf = phnloop_viterbi.viterbi_block(phnloop.init_carry(spec, B, dev),
                                          lp_of(full), 0, *args)
    ro = rng.integers(0, 161, B)
    rows = i32(ro)[None, :].long() + torch.arange(T, device=dev)[:, None]
    win = [h.gather(0, rows).contiguous() for h in hf]
    f0 = ro + rng.integers(0, 200, B)
    f0[::11] = ro[::11] - 5                    # a boundary before the window
    n_rel = rng.integers(0, T + 1, B)
    n_rel[::7] = T
    smax = phnloop.max_segments(spec, T)
    dargs = (*win, i32(n_rel), i32(f0), i32(ro), smax)
    sk = backtrack.backtrack_committed(*dargs)
    sp = backtrack.backtrack_committed_plain(*dargs)
    zero = i32(np.zeros(B))
    n_pos = i32(np.maximum(n_rel, 1))
    zk = backtrack.backtrack_committed(*win, n_pos, zero, zero, smax)
    dk = backtrack.backtrack(*win, n_pos, smax)
    torch.cuda.synchronize()
    checks = {w: torch.equal(a, b) for a, b, w in zip(
        sk, sp, ("count", "phn", "start", "alpha_end"))}
    checks["frame0 = row_offset = 0 == kernel D"] = all(
        torch.equal(a, b) for a, b in zip(zk, dk))
    walk = _walk_times(lambda: backtrack.backtrack_committed(*dargs),
                       lambda: backtrack.backtrack_committed_plain(*dargs),
                       sk[0])
    phase("backtrack_committed", T=T, B=B, smax=smax, equal=checks, **walk)
    if not all(checks.values()):
        raise AssertionError(f"backtrack_committed: {checks}")
    return ragged, dict(max_abs_err=0.0, **walk,
                        **bound(*_walk_work(sk[0], smax, 2, 2), PEAK_FP32))


def _walk_times(kernel, plain, count: torch.Tensor) -> dict:
    """A walk's times by both timers (cuda_ms, the smoke's, and
    scan_variants.held_ms, the card held while the host enqueues), the
    plain version's, the held time in clocks a hop of the longest row,
    and the hops a row (mean, max)."""
    t_k = cuda_ms(kernel)
    held = scan_variants.held_ms(kernel)
    t_p = cuda_ms(plain, iters=3, warmup=1)
    max_hops = int(count.max())
    mhz = sm_clock(kernel, max(t_k, 0.2))
    return dict(ms=t_k, held_ms=held, plain_ms=t_p, sm_clock_mhz=mhz,
                clocks_a_hop=held * 1e-3 * mhz * 1e6 / max(max_hops, 1),
                mean_count=float(count.float().mean()), max_count=max_hops)


def check_walk_cases(dev) -> None:
    """Kernels D and D' against their plain versions on
    backtrack_variants.WALK_CASES (int16 and int32 starts; T below one
    chunk, over many and the serving T 6,146; B 13, 1 and 256; hops of
    exactly 1, 3, 4, 64, 128 and 256 frames landing on chunk edges; rows of
    one segment; Smax below a row's hop count; pointers off alignment; D'
    with frame0 before, at, inside and past the window and empty windows),
    every output bit-equal with its dtype, and D' with frame0 = row_offset
    = 0 equal to D."""
    recs = backtrack_variants.check_walk_cases(
        backtrack.backtrack, backtrack.backtrack_committed, dev)
    bad = [r for r in recs if r["bad"]]
    phase("backtrack_cases", cases=len(recs), bit_equal=not bad, bad=bad,
          hops={r["case"]: r["hops_D"] for r in recs})
    if bad:
        raise AssertionError(f"backtrack cases differ: {bad}")


def check_viterbi_cases(dev) -> None:
    """Kernels C and C' against their plain versions on
    scan_variants.VITERBI_CASES (S 1-5 at P up to 32, 64, 96 and 128:
    every template instance; B 1 and 13, T 1 and one that fills no chunk,
    n_valid 0, T and ragged, two blocks chained through the carry,
    tie-heavy observations with -0.0) and VITERBI_WIDE_CASES (S 6, 7 and
    120, rows of 4,100 and 5,000 columns: the run-time-S kernel, its carry
    in shared and in device memory): carry and valid History bit-equal; a
    wide case (S 6 at the CZ loop's B 256 x T 500) timed; and 129
    phonemes refused (the int8 History)."""
    recs = []
    for cases in (scan_variants.VITERBI_CASES,
                  scan_variants.VITERBI_WIDE_CASES):
        recs += scan_variants.check_viterbi_cases(
            phnloop_viterbi.viterbi_block,
            phnloop_viterbi.viterbi_block_ragged, dev, cases)
    bad = [r for r in recs if r["bad"]]
    # 129 phonemes: phnrec_tpu's int8 History wraps the winner; the kernel
    # refuses the loop before any launch
    spec = phnloop.PhnLoopSpec(n_phonemes=129, n_states=1, w_penalty=-1.0)
    try:
        phnloop_viterbi.viterbi_block(
            phnloop.init_carry(spec, 2, dev),
            torch.zeros((2, 3, 129), device=dev), 0, 129, 1, -1.0,
            spec.log_tr_curr, spec.log_tr_next)
        refused = False
    except ValueError as e:
        refused = "int8" in str(e)
    # the wide path timed: S 6 at B 256 x T 500
    spec, lp, _, _ = scan_variants.viterbi_case(dev, 46, 6, 256, 500, 276,
                                                seed=115)
    args = scan_variants._spec_args(spec)
    carry = phnloop.init_carry(spec, 256, dev)
    fn = lambda: phnloop_viterbi.viterbi_block(carry, lp, 0, *args)  # noqa: E731
    held = scan_variants.held_ms(fn)
    wide = dict(P=46, S=6, B=256, T=500, D=276, ms=cuda_ms(fn),
                held_ms=held, **clocks(fn, held, 500))
    phase("phnloop_viterbi_cases", cases=len(recs), bit_equal=not bad,
          bad=bad, wide_cases=list(scan_variants.VITERBI_WIDE_CASES),
          p129_refused=refused, wide_timed=wide)
    if bad or not refused:
        raise AssertionError(f"phnloop_viterbi cases differ: {bad}, "
                             f"129 phonemes refused: {refused}")


def label_key(labels):
    return [(l.start_frames, l.end_frames, l.name) for l in labels]


def run_cli(pkg: str, tmp: str, cpu_sr, dev) -> tuple:
    """64 seeded int16 files of 1-8 s through the CLI, the user's entry
    point; returns each kernel's launch count over the run and its wall
    (s)."""
    from phnrec_tpu_torch import cli
    wav_dir = os.path.join(tmp, "wav")
    os.makedirs(wav_dir)
    paths = synth.write_audio_files(wav_dir, 64, (1.0, 8.0), seed=11)
    lst, mlf = os.path.join(tmp, "list.scp"), os.path.join(tmp, "out.mlf")
    with open(lst, "w") as f:
        f.write("".join(p + "\n" for p in paths))
    reset_counts(BATCH_KERNELS)
    torch.cuda.synchronize()
    t = time.perf_counter()
    rc = cli.main(["-c", pkg, "-l", lst, "-m", mlf, "--device", str(dev)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = read_counts(BATCH_KERNELS)
    if rc != 0:
        raise AssertionError(f"cli returned {rc}")
    got = read_mlf(mlf)
    names = {l.name for labs in got.values() for l in labs}
    if len(got) != 64 or any(not labs for labs in got.values()):
        raise AssertionError(f"MLF holds {len(got)} entries, some empty")
    if len(names) < 10:
        raise AssertionError(f"only {len(names)} distinct phonemes")
    if any(v == 0 for v in launches.values()):
        raise AssertionError(f"a kernel was not launched: {launches}")
    # the first files again on the CPU (plain versions), as a reference
    from phnrec_tpu_torch.io.audio import convert_waveform
    waves = [convert_waveform(open(p, "rb").read())[0] for p in paths[:4]]
    ref = cpu_sr.batch_pipeline.run(waves).labels
    keys = list(got)
    same = [label_key(ref[i]) == label_key(got[keys[i]]) for i in range(4)]
    phase("cli", files=64, audio_s=sum(os.path.getsize(p) / 2 / 8000
                                       for p in paths),
          wall_s=wall, labels=sum(len(v) for v in got.values()),
          distinct_phonemes=len(names), launches=launches,
          cpu_reference_equal=same)
    if not all(same):
        raise AssertionError("CLI labels differ from the CPU reference")
    return launches, wall


def timed_batch(sr, dev, B: int = 1024, reference=None, name="batch"):
    """BatchPipeline._core at batch B x 5 s in the current precision mode,
    per-stage CUDA events; 8 rows again through the plain versions on the
    card.  Returns the labels; given ``reference`` labels (another mode's),
    counts the utterances whose label strings and boundaries agree.
    ``name`` names the phase (another package's batch)."""
    from phnrec_tpu_torch.parallel.batch import BatchPipeline
    n = 5 * 8000
    rng = np.random.default_rng(12)
    wave = np.stack([synth.synth_audio(rng, n) for _ in range(B)])
    n_samples = np.full(B, n, np.int32)
    bp = sr.batch_pipeline
    w, nf, max_frames, ns = bp.to_device(wave, n_samples)
    phnloop.fetch_segments(bp._core(w, nf, max_frames, ns))     # warm-up
    events = []

    def hook(stage):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((stage, ev))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    bp.stage_hook = hook
    t = time.perf_counter()
    hook("start")
    segs = phnloop.fetch_segments(bp._core(w, nf, max_frames, ns))
    hook("fetch")
    labels = phnloop.labels_from_segments(segs, nf.cpu().numpy(),
                                          sr.phonemes)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    bp.stage_hook = None
    stages = {s: events[i - 1][1].elapsed_time(ev)
              for i, (s, ev) in enumerate(events) if i}
    stages["labels_host"] = (wall * 1e3 - sum(stages.values()))
    peak = torch.cuda.max_memory_allocated(dev)

    plain = BatchPipeline(sr, plain=True).run_padded(wave[:8], n_samples[:8])
    same = [label_key(labels[i]) == label_key(plain.labels[i])
            for i in range(8)]
    agree = None if reference is None else dict(
        utterances=B, equal=sum(label_key(a) == label_key(b)
                                for a, b in zip(labels, reference)),
        labels=sum(map(len, labels)),
        reference_labels=sum(map(len, reference)))
    phase(name, precision=precision.get_mode(), batch=B, seconds_each=5,
          frames=max_frames, audio_s_per_s=B * 5 / wall, wall_s=wall,
          stage_ms=stages, max_memory_allocated_bytes=peak,
          labels_per_utt=float(np.mean([len(l) for l in labels])),
          plain_equal_rows=same, agreement_with_highest=agree)
    if not all(same):
        raise AssertionError("kernel labels differ from the plain versions")
    return labels


def build_all() -> None:
    """One nvcc per kernel source, all started together."""
    t = time.perf_counter()

    def one(name):
        t0 = time.perf_counter()
        _build.build(name)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(SOURCES)) as ex:
        secs = dict(zip(SOURCES, ex.map(one, SOURCES)))
    for name in SOURCES:
        _build.load(name)
        log = _build.build_log(name) or "(cached)"
        info = [l.strip() for l in log.splitlines()
                if "registers" in l or "spill" in l]
        phase("build", kernel=name, seconds=secs[name], ptxas=info)
    phase("build_total", seconds=time.perf_counter() - t)


def _live_equal(got, want, live) -> bool:
    return torch.equal(torch.where(live, got, torch.zeros_like(got)),
                       torch.where(live, want, torch.zeros_like(want)))


def check_netstep(dense, dev, n: int = 256, F: int = 512):
    """Kernel B against its plain version (the DenseKWSScan.step loop) on
    the EN KWS net: the same entries live (value > NEG / 2), and sink
    records and carry bit-equal on them.  Beam off and 8.0 on each of:
    n 256 x F 512 with normal observations (timed) and with small-integer
    ones (many ties, counted); n 4; n 13 (not a multiple of the kernel's
    4 streams a block); F 1; every stream's n_valid 0; the carry passed
    between two blocks, which must equal one block; and two random
    networks wider than the EN one (synth.dense_kws_net, every closure
    column distinct): 96 models x 2 states, whose tables fill shared
    memory past 48 KB, and 340 x 3 (1,020 states), whose tables do not
    fit and are read from global memory.  Returns B's result and its
    beam-off output."""
    nets = {"en": dense, "wide_smem": synth.dense_kws_net(96, 2, 2, seed=1),
            "wide_global": synth.dense_kws_net(340, 3, 5, seed=2)}
    blks = {k: netstep.build_net_block_fn(v) for k, v in nets.items()}
    if None in blks.values():
        raise AssertionError(f"the structure gate rejected a net: {blks}")
    cases = {"main": ("en", n, F, dict(seed=21)),
             "ties": ("en", n, F, dict(seed=23, ties=True)),
             "n4": ("en", 4, F, dict(seed=24)),
             "n13": ("en", 13, F, dict(seed=25)),
             "F1": ("en", n, 1, dict(seed=26)),
             "all_dead": ("en", n, 64, dict(seed=27, dead=True)),
             "two_blocks": ("en", n, F, dict(seed=28)),
             "wide_smem": ("wide_smem", 6, 24, dict(seed=29)),
             "wide_global": ("wide_global", 6, 24, dict(seed=30))}
    out, bad = {}, []
    for case, (net, cn, cF, kw) in cases.items():
        dense, blk = nets[net], blks[net]
        carry0, obs, n_valid, n_dec = b_inputs(dense, dev, cn, cF, **kw)
        for bw in (float(OFF_BEAM), 8.0):
            beam = torch.full((cn,), bw, device=dev)
            args = (carry0, obs, n_valid, n_dec, beam)
            got = blk(*args)
            want = netstep.net_block_plain(dense, *args)
            torch.cuda.synchronize()
            checks = netstep.compare_live(got, want)
            extra = {}
            if case == "two_blocks":
                # frames [0, h) then [h, F) with the carry, n_dec and
                # n_valid passed on: the records and carry of one block
                h = cF // 2 - 3
                c1, (sv1, sw1) = blk(carry0, obs[:h].contiguous(),
                                     n_valid.clamp(max=h), n_dec, beam)
                c2, (sv2, sw2) = blk(c1, obs[h:].contiguous(),
                                     (n_valid - h).clamp(min=0), n_dec + h,
                                     beam)
                two = (c2, (torch.cat([sv1, sv2]), torch.cat([sw1, sw2])))
                checks.update({f"two_blocks_{k}": v for k, v in
                               netstep.compare_live(two, want).items()})
                extra["two_equal_one"] = all(
                    torch.equal(a, b) for a, b in zip(
                        (*two[0], *two[1]), (*got[0], *got[1])))
                checks["two_blocks_equal_one"] = extra["two_equal_one"]
            if case == "ties":
                extra["ties_closure_sink"] = netstep.count_ties(dense, *args)
            live = want[1][0] > NEG / 2
            rec = dict(case=case, n=cn, F=cF, M=dense.M, E=dense.E,
                       S=dense.n_sinks, distinct_columns=blk.U, beam=bw,
                       live_sink_share=float(live.float().mean()),
                       bit_equal=all(checks.values()), **extra)
            if case == "main":
                t_k = cuda_ms(lambda: blk(*args))
                held = scan_variants.held_ms(lambda: blk(*args))
                t_p = cuda_ms(lambda: netstep.net_block_plain(dense, *args),
                              iters=2, warmup=1)
                clk = clocks(lambda: blk(*args), t_k, cF)
                rec.update(ms=t_k, held_ms=held, plain_ms=t_p, **clk)
                # bytes: the live frames' observations read, the sink
                # records written, the carry read and written; operations
                # per live frame and stream: ~7 per state (three
                # candidates, the observation, the beam max), one per model
                # exit, two per live closure or sink edge
                live_rows = int(n_valid.sum())
                E, M, S = dense.E, dense.M, dense.n_sinks
                nnz = int((dense.A_cm > NEG / 2).sum()
                          + (dense.A_cs[:, :S] > NEG / 2).sum())
                n_bytes = live_rows * E * 4 + cF * cn * S * 8 + \
                    2 * cn * (2 * E + 2 * M) * 4 + cn * 12
                ops = live_rows * (7 * E + M + 2 * nnz)
                out[bw] = dict(max_abs_err=0.0, ms=t_k, held_ms=held,
                               plain_ms=t_p,
                               **bound(n_bytes, ops, PEAK_FP32),
                               **clk,
                               sinks=got[1], n_valid=n_valid, n_dec=n_dec)
            phase("netstep", **rec)
            if not all(checks.values()):
                bad.append((case, bw, {k: v for k, v in checks.items()
                                       if not v}))
    if bad:
        raise AssertionError(f"netstep differs from the plain version: "
                             f"{bad}")
    return out


def check_lrtrace(c, b_out, dev, n: int = 256, F: int = 512):
    """Kernel F against its plain version, every field equal: on kernel
    B's beam-off output, and on sink records built to emit often
    (random-walk LRs with dead stretches), time_pruning 40 and off; then
    on scan_variants.LRTRACE_CASES (K 1, 2, 13, 33, 70, 96 and 128 on
    crafted records, n 1, 13 and 256, F 1 and one that fills no chunk,
    every stream dead, tie-heavy small-integer records) and two blocks
    chained through the state."""
    from phnrec_tpu_torch.decoder.stknet import lrtrace_init_state
    ws = torch.tensor(c.kws_word_sinks, dtype=torch.int32, device=dev)
    fs, K = c.kws_filler_sink, len(c.kws_word_sinks)
    S = b_out["sinks"][0].shape[2]
    rng = np.random.default_rng(22)
    walk = np.cumsum(rng.normal(0, 1, (F, n, S)), axis=0) - 40
    walk[rng.random((F, n, S)) < 0.1] = NEG
    # word starts jump to the current frame every 20-80 frames (new
    # hypotheses) and age in between (time pruning)
    seg = rng.integers(20, 80, (1, n, S))
    starts = b_out["n_dec"].cpu().numpy()[None, :, None] + \
        np.arange(F)[:, None, None] // seg * seg
    crafted = (torch.from_numpy(walk.astype(np.float32)).to(dev),
               torch.from_numpy(starts.astype(np.int32)).to(dev))
    res = None
    for what, (sv, sw) in (("netstep", b_out["sinks"]),
                           ("crafted", crafted)):
        for tp in (40, 1e10):
            args = (lrtrace_init_state(K, n, dev), sv, sw, ws, fs,
                    b_out["n_dec"], b_out["n_valid"], tp, -1e30)
            sk, ek = lrtrace.lrtrace_scan(*args)
            sp, ep = lrtrace.lrtrace_scan_plain(*args)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(sk, sp)) and all(
                torch.equal(ek[r][k], ep[r][k]) for r in range(2)
                for k in ek[r])
            t_k = cuda_ms(lambda: lrtrace.lrtrace_scan(*args))
            t_p = cuda_ms(lambda: lrtrace.lrtrace_scan_plain(*args),
                          iters=2, warmup=1)
            phase("lrtrace", input=what, n=n, F=F, K=K,
                  time_pruning=tp, equal=same,
                  emits=[int(ek[r]["emit"].sum()) for r in range(2)],
                  ms=t_k, plain_ms=t_p)
            if not same:
                raise AssertionError(f"lrtrace {what} tp={tp} differs")
            if what == "netstep" and tp == 40:
                clk = clocks(lambda: lrtrace.lrtrace_scan(*args), t_k, F)
                phase("lrtrace_clocks", n=n, F=F, K=K, **clk)
                # bytes: the live frames' keyword and filler sink values
                # and keyword weights read, both event records written
                # (14 bytes a keyword and frame), the state read and
                # written; ~20 compares, adds and selects a keyword and
                # live frame
                live_rows = int(b_out["n_valid"].sum())
                n_bytes = live_rows * (2 * K + 1) * 4 + \
                    2 * n * F * K * 14 + 2 * n * K * 21 + n * 8
                res = dict(max_abs_err=0.0, ms=t_k, plain_ms=t_p,
                           **bound(n_bytes, live_rows * K * 20, PEAK_FP32),
                           **clk)
    recs = scan_variants.check_lrtrace_cases(lrtrace.lrtrace_scan, dev)
    recs += scan_variants.check_lrtrace_cases(
        lrtrace.lrtrace_scan, dev, scan_variants.LRTRACE_WIDE_CASES)
    bad = [r for r in recs if r["bad"]]
    # past 128 keywords (groups of 128) timed: K 200 at n 256 x F 512
    st, sv, sw, ws, fs, nd, nv = scan_variants.lrtrace_case(
        dev, 256, 512, 200, 203, seed=116)
    fn = lambda: lrtrace.lrtrace_scan(st, sv, sw, ws, fs,  # noqa: E731
                                      nd, nv, 40, -1e30)
    held = scan_variants.held_ms(fn)
    phase("lrtrace_cases", cases=len(recs), equal=not bad, bad=bad,
          wide_cases=list(scan_variants.LRTRACE_WIDE_CASES),
          wide_timed=dict(n=256, F=512, K=200, ms=cuda_ms(fn), held_ms=held,
                          **clocks(fn, held, 512)))
    if bad:
        raise AssertionError(f"lrtrace cases differ: {bad}")
    return res


# LRTrace's settings (improveKwdEstim, keyword 0's quirk), the serving
# defaults first
LRTRACE_SETTINGS = ((False, True), (True, True), (False, False),
                    (True, False))


def _setting(s) -> str:
    return f"improve={int(s[0])},quirk={int(s[1])}"


def check_lrtrace_settings(dev) -> dict:
    """Kernel F at each pair of LRTrace's settings against its plain
    version at the same pair, every field bit-equal: n 1 and 256 streams,
    K 2 and 200 keywords (groups of 128 past 128), F 256, time pruning 40,
    on records built to flush often; then each pair's held time at n 256
    x F 512 x K 2 (scan_variants.serving_lrtrace), in turns, the default
    first and last."""
    cases, bad = [], []
    for n in (1, 256):
        for K in (2, 200):
            args = scan_variants.lrtrace_case(dev, n, 256, K, K + 2,
                                              seed=n + K)
            for s in LRTRACE_SETTINGS:
                got = lrtrace.lrtrace_scan(*args, 40, -1e30, *s)
                want = lrtrace.lrtrace_scan_plain(*args, 40, -1e30, *s)
                torch.cuda.synchronize()
                eq = scan_variants.lrtrace_equal(got, want)
                ok = all(eq.values())
                cases.append(dict(n=n, K=K, setting=_setting(s), equal=ok,
                                  emits=[int(got[1][r]["emit"].sum())
                                         for r in range(2)]))
                if not ok:
                    bad.append(dict(cases[-1], fields=[
                        k for k, v in eq.items() if not v]))
    args = scan_variants.serving_lrtrace(dev)
    held = {_setting(s): [] for s in LRTRACE_SETTINGS}
    for s in LRTRACE_SETTINGS + LRTRACE_SETTINGS[::-1]:
        held[_setting(s)].append(scan_variants.held_ms(
            lambda: lrtrace.lrtrace_scan(*args, *s)))
    phase("lrtrace_settings_cases", cases=cases, equal=not bad, bad=bad,
          timed=dict(n=256, F=512, K=2), held_ms_in_turns=held)
    if bad:
        raise AssertionError(f"lrtrace settings differ: {bad}")
    return {k: float(np.mean(v)) for k, v in held.items()}


class _Capture(MultiStreamKWS):
    """Records each block's log-posteriors as the decoder receives them."""

    def __init__(self, *a, **kw):
        self.lps = []
        super().__init__(*a, **kw)

    def _decode_block(self, carry, lp, n_dec, n_valid):
        self.lps.append(lp.cpu())
        return super()._decode_block(carry, lp, n_dec, n_valid)


class _Replay(MultiStreamKWS):
    """Decodes given log-posteriors instead of its own (same shapes)."""

    def __init__(self, lps, *a, **kw):
        self.lps, self.err = list(lps), 0.0
        super().__init__(*a, **kw)

    def _decode_block(self, carry, lp, n_dec, n_valid):
        given = self.lps.pop(0)
        rows = torch.arange(lp.shape[1])[None, :] < n_valid.cpu()[:, None]
        self.err = max(self.err, float(
            (given - lp).abs()[rows].max()) if rows.any() else 0.0)
        return super()._decode_block(carry, given, n_dec, n_valid)


def _feed_chunks(ms, streams, chunk: int = 32000):
    """Feed each stream's bytes in chunks through process(), round robin,
    ending each stream after its last chunk; then finish()."""
    for off in range(0, max(map(len, streams)), chunk):
        for i, x in enumerate(streams):
            if off < len(x):
                ms.process(i, x[off: off + chunk])
            elif not ms._ended[i]:
                ms.end_stream(i)
    return ms.finish()


def kws_vs_cpu(sr, cpu_sr, dev, path: str = "kernel_b", name="kws_vs_cpu",
               n: int = 4, seconds: float = 10.0, seed: int = 31):
    """4 streams of 10, 9, 8, 7 s fed in 2 s chunks through
    MultiStreamKWS.process() on the card (blocks of 512 frames), then the
    CPU port (plain versions) on the same audio, decoding the card's
    log-posteriors: hits equal (names, times, scores), through network
    path ``path`` (kernel_b or kernel_g).  The CPU port's own
    log-posteriors are held to the card's within TOL_KWS_LP."""
    fs = sr.cfg.get_int("source", "sample_freq")
    rng = np.random.default_rng(seed)
    streams = [synth.synth_audio(rng, int((seconds - i) * fs), fs)
               .astype("<i2").tobytes() for i in range(n)]
    names = ("mlp_fused", "netstep" if path == "kernel_b" else
             g_counter(sr.stk_decoder.decoder), "lrtrace")
    reset_counts(names)
    gpu = _Capture(sr, n, block_frames=512)
    got = _feed_chunks(gpu, streams)
    torch.cuda.synchronize()
    launches = read_counts(names)
    cpu = _Replay(gpu.lps, cpu_sr, n, block_frames=512)
    want = _feed_chunks(cpu, streams)
    same = [full_key(a) == full_key(b) for a, b in zip(got, want)]
    c = sr.stk_decoder.compiled
    phase(name, streams=n, seconds=seconds, block_frames=512,
          net_path=gpu.net_path, models=c.n_models, states=c.n_states,
          keywords=len(sr.stk_decoder.keywords()),
          input_xform=gpu._xform_inst is not None, launches=launches,
          hits=[len(h) for h in got], hits_equal=same,
          max_lp_err_cpu_vs_card=cpu.err, tol_lp=TOL_KWS_LP)
    if gpu.net_path != path or not all(launches.values()):
        raise AssertionError(f"{name} skipped a kernel: {launches}")
    if not all(same) or not any(got) or not cpu.err <= TOL_KWS_LP:
        raise AssertionError(f"{name}: card hits differ from the CPU "
                             "port's")
    return launches


def kws_serving(en_sr, dev, n: int = 256, seconds: float = 60.0,
                block: int = 512, runs: int = 3) -> dict:
    """MultiStreamKWS over n streams x 60 s staged on the card, through
    decode_device_buffer; launch counts of one run, then the median of
    `runs` timed runs after a warm-up, with CUDA-event stage times."""
    fs = en_sr.cfg.get_int("source", "sample_freq")
    spec = en_sr.frontend.spec
    spb = block * spec.step
    # whole blocks covering `seconds`: 12 x 5.12 s at 16 kHz
    n_blocks = -(-int(seconds * fs) // spb)
    L = n_blocks * spb + spec.vector_size - spec.step
    base = synth.synth_audio(np.random.default_rng(41), L, fs)
    audio = torch.from_numpy(np.stack(
        [np.roll(base, -s * 16001)[:L] for s in range(n)])).to(dev)

    def one_pass(hook=None):
        """-> (server, hits, seconds until the blocks' device work ended,
        seconds of finish(): tail flush, ring fetch, host decode)."""
        t = time.perf_counter()
        ms = MultiStreamKWS(en_sr, n, block_frames=block)
        ms.stage_hook = hook
        if hook:
            hook("start")
        ms.decode_device_buffer(audio, n_blocks)
        ms.stage_hook = None
        torch.cuda.synchronize()
        t_dev = time.perf_counter()
        hits = ms.finish()
        return ms, hits, t_dev - t, time.perf_counter() - t_dev

    one_pass()                                   # warm-up
    reset_counts(KWS_KERNELS)
    ms, hits, _, _ = one_pass()
    torch.cuda.synchronize()
    launches = read_counts(KWS_KERNELS)
    if ms.net_path != "kernel_b" or not launches["mlp_fused"]:
        raise AssertionError(f"KWS path {ms.net_path}: {launches}")
    # one launch of B and F per block, plus the tail flush at finish()
    if launches["netstep"] != n_blocks + 1 or \
            launches["lrtrace"] != n_blocks + 1:
        raise AssertionError(f"B/F not launched once per block: "
                             f"{launches}, {n_blocks} blocks")
    with_hits = sum(1 for h in hits if h)
    if with_hits < 0.9 * n:
        raise AssertionError(f"only {with_hits}/{n} streams have hits")

    walls, stage_runs, devs, syncs = [], [], [], []
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(runs):
        events = []

        def hook(stage):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((stage, ev))

        torch.cuda.synchronize()
        t = time.perf_counter()
        _, _, dev_s, sync_s = one_pass(hook)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        devs.append(dev_s)
        syncs.append(sync_s)
        st = {}
        for i in range(1, len(events)):
            s_name = events[i][0]
            if s_name == "netstep" or s_name == "lrtrace" or \
                    s_name == "compact" or s_name == "posteriors":
                st[s_name] = st.get(s_name, 0.0) + \
                    events[i - 1][1].elapsed_time(events[i][1])
        stage_runs.append(st)
    peak = torch.cuda.max_memory_allocated(dev)
    busy = device_busy_share(lambda: one_pass())
    wall = float(np.median(walls))
    stages = {k: float(np.median([r.get(k, 0.0) for r in stage_runs]))
              for k in ("posteriors", "netstep", "lrtrace", "compact")}
    # host wall until the blocks' device work ended, then finish() (the
    # tail flush block, the ring fetch and the host decode of the hits)
    stages["blocks_wall"] = float(np.median(devs)) * 1e3
    stages["finish"] = float(np.median(syncs)) * 1e3
    audio_s = n * L / fs
    phase("kws_serving", streams=n, seconds_each=L / fs, blocks=n_blocks,
          block_frames=block, launches=launches, net_path=ms.net_path,
          streams_with_hits=with_hits,
          hits_total=sum(len(h) for h in hits),
          wall_s=walls, audio_s_per_s=audio_s / wall, stage_ms=stages,
          max_memory_allocated_bytes=peak, device_busy_share=busy)
    return launches


class _PCapture(MultiStreamRecognizer):
    """Records each block's log-posteriors as the decoder receives them."""

    def __init__(self, *a, **kw):
        self.lps = []
        super().__init__(*a, **kw)

    def _decode_block(self, carry, lp, n_dec, n_valid):
        self.lps.append(lp.cpu())
        return super()._decode_block(carry, lp, n_dec, n_valid)


class _PReplay(MultiStreamRecognizer):
    """Decodes given log-posteriors instead of its own, after measuring
    its own against them on the valid rows."""

    def __init__(self, lps, *a, **kw):
        self.lps, self.err = list(lps), 0.0
        super().__init__(*a, **kw)

    def _decode_block(self, carry, lp, n_dec, n_valid):
        given = self.lps.pop(0)
        rows = torch.arange(lp.shape[1])[None, :] < n_valid.cpu()[:, None]
        if rows.any():
            self.err = max(self.err, float((given - lp).abs()[rows].max()))
        return super()._decode_block(carry, given, n_dec, n_valid)


class _SCapture(StreamingRecognizer):
    def __init__(self, *a, **kw):
        self.lps = []
        super().__init__(*a, **kw)

    def _decode(self, lp, n_rows):
        self.lps.append(lp.cpu())
        super()._decode(lp, n_rows)


class _SReplay(StreamingRecognizer):
    def __init__(self, lps, *a, **kw):
        self.lps, self.err = list(lps), 0.0
        super().__init__(*a, **kw)

    def _decode(self, lp, n_rows):
        given = self.lps.pop(0)
        self.err = max(self.err, float((given - lp)[:n_rows].abs().max()))
        super()._decode(given, n_rows)


def full_key(labels):
    return [(l.start_frames, l.end_frames, l.name, l.score) for l in labels]


def phnloop_vs_cpu(sr, cpu_sr, dev, n: int = 4, seconds: float = 10.0):
    """Phoneme-loop serving on the card against the CPU port (plain
    versions), at precision "highest": 4 streams of 10, 9, 8, 7 s fed in
    2 s chunks through MultiStreamRecognizer.process(), blocks of 512
    frames, and stream 0 in 1 s chunks through StreamingRecognizer.  The
    CPU port decodes the card's log-posteriors and must give the card's
    labels exactly (names, boundaries, scores); its own log-posteriors
    are held to the card's within TOL_PHN_LP; its labels from its own
    log-posteriors are compared and reported."""
    rng = np.random.default_rng(51)
    streams = [synth.synth_audio(rng, int((seconds - i) * 8000))
               .astype("<i2").tobytes() for i in range(n)]

    def stream(rec):
        for off in range(0, len(streams[0]), 16000):
            rec.process(streams[0][off: off + 16000])
        return rec.finish()

    names = ("mlp_fused", "phnloop_viterbi", "phnloop_viterbi_ragged",
             "backtrack")
    reset_counts(names)
    gpu = _PCapture(sr, n, block_frames=512)
    got = _feed_chunks(gpu, streams)
    torch.cuda.synchronize()
    launches = read_counts(names)
    cpu = _PReplay(gpu.lps, cpu_sr, n, block_frames=512)
    want = _feed_chunks(cpu, streams)
    own = _feed_chunks(MultiStreamRecognizer(cpu_sr, n, block_frames=512),
                       streams)
    same = [full_key(a) == full_key(b) for a, b in zip(got, want)]
    s_gpu = _SCapture(sr, block_frames=512)
    s_got = stream(s_gpu)
    s_cpu = _SReplay(s_gpu.lps, cpu_sr, block_frames=512)
    s_want = stream(s_cpu)
    s_same = full_key(s_got) == full_key(s_want)
    phase("phnloop_vs_cpu", streams=n, seconds=seconds, block_frames=512,
          launches=launches, labels=[len(x) for x in got],
          labels_equal=same, max_lp_err_cpu_vs_card=cpu.err,
          own_lp_labels_equal=[label_key(a) == label_key(b)
                               for a, b in zip(got, own)],
          streaming_labels=len(s_got), streaming_equal=s_same,
          streaming_max_lp_err=s_cpu.err,
          streaming_vs_multistream_equal=label_key(s_got) ==
          label_key(got[0]), tol_lp=TOL_PHN_LP)
    if not launches["mlp_fused"] or not launches["phnloop_viterbi_ragged"]:
        raise AssertionError(f"phnloop path skipped a kernel: {launches}")
    if not all(same) or not s_same or not all(got):
        raise AssertionError("card labels differ from the CPU port's")
    if not max(cpu.err, s_cpu.err) <= TOL_PHN_LP:
        raise AssertionError(f"log-posteriors differ by "
                             f"{max(cpu.err, s_cpu.err)}")


def _serving_audio(sr, dev, n: int, n_blocks: int, block: int):
    spec = sr.frontend.spec
    L = n_blocks * block * spec.step + spec.vector_size - spec.step
    base = synth.synth_audio(np.random.default_rng(61), L)
    return torch.from_numpy(np.stack(
        [np.roll(base, -s * 8001)[:L] for s in range(n)])).to(dev), L


def phnloop_serving(sr, dev, n: int = 256, n_blocks: int = 12,
                    block: int = 512, runs: int = 3,
                    time_walk: bool = False) -> dict:
    """MultiStreamRecognizer over n streams x 12 blocks of 512 frames
    (61.44 s at 8 kHz) staged on the card as int16, through
    decode_device_buffer then finish(), in the current precision mode:
    launch counts of one run, whose labels (from kernel D's walk over the
    merged History) must equal the plain walk's over the same History,
    then the median of `runs` timed runs after a warm-up, with CUDA-event
    stage times; with ``time_walk``, kernel D's times at that History.
    Returns (launches, labels, the walk's times or None)."""
    fs = sr.cfg.get_int("source", "sample_freq")
    audio, L = _serving_audio(sr, dev, n, n_blocks, block)

    def one_pass(hook=None):
        t = time.perf_counter()
        ms = MultiStreamRecognizer(sr, n, block_frames=block)
        ms.stage_hook = hook
        if hook:
            hook("start")
        ms.decode_device_buffer(audio, n_blocks)
        torch.cuda.synchronize()
        t_dev = time.perf_counter()
        labels = ms.finish()
        torch.cuda.synchronize()
        return labels, t_dev - t, time.perf_counter() - t_dev, ms

    one_pass()                                   # warm-up
    mlp = "mlp_fused" if precision.mlp_passes() == 0 else "mlp_bf16x3"
    names = (mlp, "phnloop_viterbi_ragged", "backtrack")
    reset_counts(names)
    labels, _, _, ms = one_pass()
    launches = read_counts(names)
    # 3 nets a block and the tail flush; C' a block and the flush; D once
    if launches != {mlp: 3 * (n_blocks + 1),
                    "phnloop_viterbi_ragged": n_blocks + 1, "backtrack": 1}:
        raise AssertionError(f"phnloop serving launches: {launches}")
    if sum(1 for x in labels if len(x) > 10) < n:
        raise AssertionError("a stream decoded too few labels")
    # kernel D at the serving shapes: the plain walk over the same merged
    # History (every stream's whole run) gives the path's own labels
    hist = ms._window(ms._hist_device_uniform())
    segs = phnloop.backtrack_device(sr.loop_spec, hist, ms._i32(ms._n_dec),
                                    plain=True)
    plain = phnloop.labels_from_segments(
        phnloop.fetch_segments(segs, cap=min(4096, segs.phn.shape[1])),
        ms._n_dec, sr.phonemes)
    walk_equal = sum(full_key(a) == full_key(b)
                     for a, b in zip(labels, plain))
    phase("phnloop_serving_walk", precision=precision.get_mode(), streams=n,
          history_rows=hist.max_phn.shape[0], smax=segs.phn.shape[1],
          streams_equal_to_plain_walk=walk_equal)
    if walk_equal != n:
        raise AssertionError(f"kernel D's labels differ from the plain "
                             f"walk's on {n - walk_equal} streams")
    walk = None
    if time_walk:
        args = (*(h.contiguous() for h in hist), ms._i32(ms._n_dec),
                segs.phn.shape[1])
        walk = dict(T=hist.max_phn.shape[0], B=n, smax=args[-1], launches=1,
                    **_walk_times(lambda: backtrack.backtrack(*args),
                                  lambda: backtrack.backtrack_plain(*args),
                                  segs.count),
                    **bound(*_walk_work(segs.count, args[-1], 2, 0),
                            PEAK_FP32))
        phase("backtrack_serving", **walk)

    walls, stage_runs, devs, fins = [], [], [], []
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(runs):
        events = []

        def hook(stage):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((stage, ev))

        torch.cuda.synchronize()
        t = time.perf_counter()
        _, dev_s, fin_s, _ = one_pass(hook)
        walls.append(time.perf_counter() - t)
        devs.append(dev_s)
        fins.append(fin_s)
        st = {}
        for i in range(1, len(events)):
            name = events[i][0]
            st[name] = st.get(name, 0.0) + \
                events[i - 1][1].elapsed_time(events[i][1])
        stage_runs.append(st)
    peak = torch.cuda.max_memory_allocated(dev)
    busy = device_busy_share(lambda: one_pass())
    wall = float(np.median(walls))
    stages = {k: float(np.median([r.get(k, 0.0) for r in stage_runs]))
              for k in ("posteriors", "viterbi", "compact", "backtrack",
                        "fetch")}
    # host wall until the blocks' device work ended, then finish() (the
    # tail flush block, the walk, the segment fetch, the label objects)
    stages["blocks_wall"] = float(np.median(devs)) * 1e3
    stages["finish"] = float(np.median(fins)) * 1e3
    phase("phnloop_serving", precision=precision.get_mode(), streams=n,
          seconds_each=L / fs, blocks=n_blocks, block_frames=block,
          launches=launches, labels_total=sum(map(len, labels)),
          wall_s=walls, audio_s_per_s=n * L / fs / wall, stage_ms=stages,
          max_memory_allocated_bytes=peak, device_busy_share=busy)
    return launches, labels, walk


class _PFeed(MultiStreamRecognizer):
    """Decodes given log-posteriors (another run's decoder inputs) and
    computes none of its own: its frontend and bookkeeping run, the MLPs
    do not."""

    def __init__(self, lps, *a, **kw):
        self.lps = list(lps)
        super().__init__(*a, **kw)

    def _decode_ctx(self, ctx, skip, carry, n_dec, n_valid, cap):
        return self._decode_block(carry, self.lps.pop(0).to(ctx.device),
                                  n_dec.to(torch.int32),
                                  n_valid.to(torch.int32))


def phnloop_commit(sr, cpu_sr, dev, full, n: int = 256, n_blocks: int = 12,
                   block: int = 512, horizon: int = 256) -> dict:
    """The serving run again with commit_horizon, one decode_device_buffer
    call a block (as a server drains its buffer), so the fixed-lag commit
    runs on the device walk (kernel D') every block from the third on and
    the retained History never leaves the card.  A second run records the
    decoder's inputs, and the CPU port (plain versions) decodes them with
    the same commits: labels, scores and commit points must be the card's.
    How many streams' labels equal the run without commit (``full``) is
    measured, not asserted: the JAX package's tests expect equality where
    paths settle within the lag, on speech through trained nets, which
    random weights on synthetic audio do not promise."""
    audio, L = _serving_audio(sr, dev, n, n_blocks, block)

    def run(cls, rec_sr, audio_in, *pre):
        ms = cls(*pre, rec_sr, n, block_frames=block, commit_horizon=horizon)
        retained = []
        for k in range(n_blocks):
            ms.decode_device_buffer(audio_in, 1, first_block=k)
            retained.append(len(ms._hist))
        on_card = all(isinstance(h[0], torch.Tensor) and
                      h[0].device == audio_in.device for h, _ in ms._hist)
        return ms, retained, on_card, ms.finish()

    names = ("backtrack_committed", "backtrack")
    reset_counts(names)
    torch.cuda.synchronize()
    t = time.perf_counter()
    ms, retained, on_card, got = run(MultiStreamRecognizer, sr, audio)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = read_counts(names)
    if not launches["backtrack_committed"] or not on_card or \
            ms._frame0.min() <= 0:
        raise AssertionError("the commit did not run on the device walk")
    if max(retained) > 4:
        raise AssertionError(f"retained history grew: {retained}")

    cap, _, _, cap_got = run(_PCapture, sr, audio)
    cpu, _, _, want = run(_PFeed, cpu_sr, audio.cpu(), cap.lps)
    same = sum(full_key(a) == full_key(b) for a, b in zip(cap_got, want))
    rerun = sum(full_key(a) == full_key(b) for a, b in zip(got, cap_got))
    exact = sum(label_key(a) == label_key(b) for a, b in zip(got, full))
    phase("phnloop_commit", streams=n, blocks=n_blocks, block_frames=block,
          commit_horizon=horizon, launches=launches,
          retained_blocks=retained, history_on_card=on_card,
          committed_min=int(ms._frame0.min()), wall_s=wall,
          cpu_port_equal=same, rerun_equal=rerun,
          cpu_port_frame0_equal=bool(np.array_equal(cap._frame0,
                                                    cpu._frame0)),
          full_decode_equal=exact)
    if same != n or rerun != n or not np.array_equal(cap._frame0,
                                                     cpu._frame0):
        raise AssertionError(f"committed labels: {n - same} streams differ "
                             f"from the CPU port's, {n - rerun} between "
                             "two runs on the card")
    return launches


# ---------------------------------------------------------------------------
# offline STK-network decoding: kernels G (netscan) and H (nettrace)
# ---------------------------------------------------------------------------
def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal with the same dtype, floats by their bits."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _stk_obs(dec, B: int, T: int, seed: int, dev, ties: bool = False):
    """[B, T, E] per-state observations on the card from seeded
    log-posteriors (``ties``: multiples of -1/4 and signed zeros)."""
    rng = np.random.default_rng(seed)
    D = int(dec.c.obs_index.max()) + 1
    if ties:
        lp = -rng.integers(0, 8, (B, T, D)).astype(np.float32) / 4
        lp[rng.random((B, T, D)) < 0.1] = -0.0
    else:
        lp = np.log(rng.dirichlet(np.ones(D), size=(B, T))).astype(
            np.float32)
    return dec.state_observations(torch.from_numpy(lp).to(dev))


def _i32(a, dev):
    return torch.from_numpy(np.asarray(a, np.int32)).to(dev)


def _netscan_case(dec, dev, B, T, seed, ties=False, beam=None, t0=None,
                  force_global=False):
    """Kernel G's instances against the plain version on one input, each
    forced where the network fits it (the block instance with its values
    in device memory under ``force_global``): ({instance: equal}, the
    planned instance's records, n_valid)."""
    rng = np.random.default_rng(seed)
    obs = _stk_obs(dec, B, T, seed, dev, ties)
    t0 = np.zeros(B, np.int32) if t0 is None else t0
    nv = t0 + rng.integers(0, T + 1, B)
    nv[:: 5] = t0[:: 5] + T
    beam = np.full(B, OFF_BEAM, np.float32) if beam is None else beam
    args = (dec.init_carry(dev, B), obs, _i32(t0, dev), _i32(nv, dev),
            torch.from_numpy(np.asarray(beam, np.float32)).to(dev),
            dec.edge_tables(dev))
    if t0.any():
        # a carry one block in: the first T frames of another input
        args = (netscan.netscan(*args)[0], *args[1:])
    cp, rp = netscan.netscan_plain(*args)
    plan = netscan.plan_instance(args[-1])
    same, recs = {}, None
    for inst in netscan.INSTANCES:
        if inst == "warp" and (force_global or plan != "warp"):
            continue
        ck, rk = netscan.launch(netscan._lib(), *args, instance=inst,
                                force_global=force_global)
        torch.cuda.synchronize()
        same[inst] = all(_bits_equal(a, b) for a, b in zip(ck, cp)) and all(
            _bits_equal(rk[k], rp[k]) for k in netscan.RECORDS)
        if inst == plan or recs is None:
            recs = rk
    return same, recs, _i32(nv, dev)


def _nettrace_case(dec, recs, nv, dev, seed, committed=False,
                   force_global=False):
    B, T = recs["in_am"].shape[:2]
    f0 = np.full(B, -1, np.int32)
    if committed:
        rng = np.random.default_rng(seed)
        f0[1::2] = rng.integers(0, T, B)[1::2]
    args = (recs, nv, _i32(f0, dev), dec.edge_tables(dev),
            dec.c.terminal_sink)
    wk = (nettrace.launch(nettrace._lib(), *args, force_global=True)
          if force_global else nettrace.nettrace(*args))
    wp = nettrace.nettrace_plain(*args)
    torch.cuda.synchronize()
    return all(_bits_equal(a, b) for a, b in zip(wk, wp)), wk


def nettrace_stage_frames(dec) -> int:
    """Frames a ring stage of kernel H's shared path for a network (0:
    its device-memory path)."""
    tb = dec.edge_tables("cpu")
    return nettrace._lib().nettrace_stage_frames(
        dec.c.n_states, dec.c.n_models, tb["in_w"].shape[0],
        tb["cm_w"].shape[0], tb["ex_w"].shape[0])


def check_netscan_cases(nets: dict, dev) -> None:
    """Kernels G and H against their plain versions, bit for bit (carry,
    all nine records of every frame, the walk's five outputs), G's warp
    and block instances each forced on every case whose network the warp
    instance takes: the CZ phoneme loop at B 256 x T 500 with ragged rows
    and at B 1 x T 500; the EN KWS net at B 8 x T 3,000; tie-heavy
    observations with signed zeros; a tight beam differing by row; a
    carried second block at t0 > 0 differing by row; the CZ loop with its
    per-row values forced to device memory (block instance); a network
    whose closure rows repeat with other edge ids, START edges at other
    slots and two edges from one source; a random word network of 1,500
    models (the block instance by the plan, its per-row values in device
    memory by themselves); H with frame0 >= 0 on every second row, and
    rows that never reach the terminal sink (n_valid 0)."""
    cz, en, big = nets["cz_loop"], nets["en_kws"], nets["random_big"]
    rr = nets["repeated_rows"]
    rng = np.random.default_rng(41)
    cases = [
        ("cz_256x500", cz, dict(B=256, T=500, seed=1)),
        ("cz_1x500", cz, dict(B=1, T=500, seed=10)),
        ("en_kws_8x3000", en, dict(B=8, T=3000, seed=2)),
        ("cz_ties", cz, dict(B=13, T=200, seed=3, ties=True)),
        ("en_ties_tight_beam", en, dict(B=8, T=300, seed=4, ties=True,
                                        beam=np.full(8, 2.0))),
        ("cz_tight_beam", cz, dict(B=16, T=300, seed=5,
                                   beam=rng.uniform(1.0, 8.0, 16))),
        ("cz_carried_t0", cz, dict(B=32, T=180, seed=6,
                                   t0=rng.integers(1, 400, 32)
                                   .astype(np.int32))),
        ("cz_forced_global", cz, dict(B=16, T=200, seed=7,
                                      force_global=True)),
        ("repeated_rows", rr, dict(B=16, T=300, seed=11, ties=True,
                                   beam=rng.uniform(0.5, 4.0, 16))),
        ("random_big_global", big, dict(B=4, T=64, seed=8, ties=True)),
    ]
    out = {}
    for name, dec, kw in cases:
        same_g, recs, nv = _netscan_case(dec, dev, **kw)
        same_h, walk = _nettrace_case(dec, recs, nv, dev, kw["seed"])
        same_hc, _ = _nettrace_case(dec, recs, nv, dev, kw["seed"],
                                    committed=True)
        # H's device-memory path on the same records
        same_hg = all(_nettrace_case(dec, recs, nv, dev, kw["seed"],
                                     committed=c, force_global=True)[0]
                      for c in (False, True))
        out[name] = dict(netscan=same_g, plan=netscan.plan_instance(
                             dec.edge_tables(dev)), nettrace=same_h,
                         nettrace_frame0=same_hc, nettrace_global=same_hg,
                         nettrace_stage_frames=nettrace_stage_frames(dec),
                         rows_ok=int(walk[0].sum()),
                         crossings=int((walk[3] >= 0).sum()))
    z = netscan._sizes(big.edge_tables(dev))
    big_smem = netscan._lib().netscan_smem_bytes(
        z["E"], z["M"], z["D"] - z["M"], z["Kin"], z["Kex"], z["Kx"], z["U"])
    phase("netscan_cases", cases=out, random_big_states=big.c.n_states,
          random_big_fits_smem=bool(big_smem))
    bad = [k for k, v in out.items()
           if not (all(v["netscan"].values()) and v["nettrace"]
                   and v["nettrace_frame0"] and v["nettrace_global"])]
    shared_h = out["cz_256x500"]["nettrace_stage_frames"] > 0
    warp = [k for k, v in out.items() if "warp" in v["netscan"]]
    if bad or big_smem or not shared_h or \
            out["random_big_global"]["nettrace_stage_frames"]:
        raise AssertionError(f"kernels G / H differ on {bad}, or the big "
                             "net took shared memory, or the CZ loop's "
                             "walk did not")
    if out["random_big_global"]["plan"] != "block" or len(warp) != len(
            out) - 2:
        raise AssertionError(f"kernel G's instances: the warp one ran on "
                             f"{warp}")


def _netscan_work(dec, B: int, T: int) -> tuple:
    """(bytes, operations) of a scan: observations read, the nine records
    written, the carry read and written once; an add and a compare per
    edge slot of every dense row, per frame and row."""
    tb, E, M, S = dec.tables, dec.c.n_states, dec.c.n_models, dec.n_sinks
    n_bytes = 4 * B * T * (E + E + 5 * M + 3 * S) + 2 * 4 * B * (2 * E + 3 * M)
    slots = sum(d.size for d in (tb.in_dense, tb.ex_dense, tb.cm_dense,
                                 tb.cs_dense))
    return n_bytes, 2 * B * T * slots


def _nettrace_work(walk, nv, B: int, T: int) -> tuple:
    """(bytes, operations) of a walk, from this run's walks: the outputs
    written once, an in_am word read a step of a live row (its valid
    frames) and three more words a crossing, the start's three words and
    the two [B] inputs; a few operations a step."""
    ok = walk[0].cpu().numpy()
    steps = int(nv.cpu().numpy()[ok].sum())
    crossings = int((walk[3] >= 0).sum())
    n_bytes = B * T * 8 + B * 9 + 4 * (steps + 3 * crossings + 3 * B + 2 * B)
    return n_bytes, 4 * steps


def time_netscan(dec, dev, B: int = 256, T: int = 500):
    """Kernels G and H at the CZ stkint batch shape (B 256 x T 500, the
    phoneme loop of 46 models): both timers, the plain versions, clocks a
    frame (G) and a step (H), bounds; G's warp and block instances each
    forced (the warp one is the plan's for this network), also at B 1 x
    T 500 (held)."""
    obs = _stk_obs(dec, B, T, 9, dev)
    nv = _i32(np.full(B, T), dev)
    beam = torch.full((B,), float(OFF_BEAM), device=dev)
    tb = dec.edge_tables(dev)
    carry = dec.init_carry(dev, B)
    t0 = _i32(np.zeros(B), dev)
    recs = netscan.netscan(carry, obs, t0, nv, beam, tb)[1]
    f0 = _i32(np.full(B, -1), dev)
    h = lambda: nettrace.nettrace(recs, nv, f0, tb,  # noqa: E731
                                  dec.c.terminal_sink)
    walk = h()
    lib = netscan._lib()

    def g(inst, rows=B):
        args = (carry, obs, t0, nv, beam) if rows == B else (
            tuple(c[:rows].contiguous() for c in carry),
            obs[:rows].contiguous(), t0[:rows].contiguous(),
            nv[:rows].contiguous(), beam[:rows].contiguous())
        return lambda: netscan.launch(lib, *args, tb, instance=inst)

    g_plain = cuda_ms(lambda: netscan.netscan_plain(carry, obs, t0, nv,
                                                    beam, tb),
                      iters=2, warmup=1)
    res = {}
    for name, fn, t_p, work, steps in (
            ("netscan_warp", g("warp"), g_plain, _netscan_work(dec, B, T), T),
            ("netscan", g("block"), g_plain, _netscan_work(dec, B, T), T),
            ("nettrace", h, cuda_ms(lambda: nettrace.nettrace_plain(
                recs, nv, f0, tb, dec.c.terminal_sink), iters=2, warmup=1),
             _nettrace_work(walk, nv, B, T), T)):
        t_k = cuda_ms(fn)
        held = scan_variants.held_ms(fn)
        mhz = sm_clock(fn, max(t_k, 0.2))
        res[name] = dict(max_abs_err=0.0, ms=t_k, held_ms=held, plain_ms=t_p,
                         sm_clock_mhz=mhz,
                         clocks_a_frame=held * 1e-3 * mhz * 1e6 / steps,
                         **bound(*work, PEAK_FP32))
    for name, inst in (("netscan_warp", "warp"), ("netscan", "block")):
        held = scan_variants.held_ms(g(inst, 1))
        res[name]["b1_held_ms"] = held
        res[name]["b1_clocks_a_frame"] = \
            held * 1e-3 * res[name]["sm_clock_mhz"] * 1e6 / T
    res["nettrace"]["clocks_a_step"] = res["nettrace"].pop("clocks_a_frame")
    phase("netscan_timing", B=B, T=T, states=dec.c.n_states,
          models=dec.c.n_models, closure_edges=len(dec.cm),
          distinct_rows=int(tb["cx_len"].shape[0]),
          rows_ok=int(walk[0].sum()), crossings=int((walk[3] >= 0).sum()),
          **res)
    return res


def stk_cli(pkg: str, tmp: str, cpu_sr, dev) -> dict:
    """64 seeded int16 files of 1-8 s of the CZ stkint decode package
    through the CLI (-l with a target column: one .rec file each); the
    first 4 files again through the CPU port's process_file_list: label
    names and boundaries equal, scores within 1e-3.  Returns the launch
    counts of the run."""
    from phnrec_tpu_torch import cli
    from phnrec_tpu_torch.io.labels import read_rec
    wav_dir = os.path.join(tmp, "stk_wav")
    os.makedirs(wav_dir)
    paths = synth.write_audio_files(wav_dir, 64, (1.0, 8.0), seed=13)
    recs = [p[:-4] + ".rec" for p in paths]
    lst = os.path.join(tmp, "stk_list.scp")
    with open(lst, "w") as f:
        f.write("".join(f"{p} {r}\n" for p, r in zip(paths, recs)))
    reset_counts(STK_KERNELS)
    t = time.perf_counter()
    rc = cli.main(["-c", pkg, "-l", lst, "--device", str(dev)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = read_counts(STK_KERNELS)
    if rc != 0:
        raise AssertionError(f"cli returned {rc}")
    got = [read_rec(r) for r in recs]
    names = {l.name for labs in got for l in labs}
    if any(not labs for labs in got) or len(names) < 10:
        raise AssertionError(f"empty rec files or {len(names)} phonemes")
    if any(v == 0 for v in launches.values()):
        raise AssertionError(f"a kernel was not launched: {launches}")
    cpu_lst = os.path.join(tmp, "stk_list_cpu.scp")
    with open(cpu_lst, "w") as f:
        f.write("".join(f"{p} {p[:-4]}.cpu.rec\n" for p in paths[:4]))
    cpu_sr.process_file_list("wf", "str", cpu_lst)
    ref = [read_rec(p[:-4] + ".cpu.rec") for p in paths[:4]]
    same = [label_key(a) == label_key(b) for a, b in zip(got, ref)]
    err = max((abs(x.score - y.score) for a, b in zip(got, ref)
               for x, y in zip(a, b)), default=0.0)
    phase("stk_cli", files=64, audio_s=sum(os.path.getsize(p) / 2 / 8000
                                           for p in paths),
          wall_s=wall, labels=sum(map(len, got)),
          distinct_labels=len(names), launches=launches,
          cpu_reference_equal=same, max_score_err=err)
    if not all(same) or not err <= 1e-3:
        raise AssertionError("CLI rec files differ from the CPU port's")
    return launches


def stk_batch(sr, dev, clk: dict, B: int = 256):
    """The stkint decode of B x 5 s at the CZ shapes, per-stage CUDA
    events (posteriors, state_obs, netscan, nettrace, fetch) and the host's
    labels; the labels equal decode_batch's, and 8 rows again through the
    plain versions of G and H on the card."""
    stk = sr.stk_decoder
    dec = stk.decoder
    n = 5 * 8000
    rng = np.random.default_rng(14)
    wave = np.stack([synth.synth_audio(rng, n) for _ in range(B)])
    n_samples = np.full(B, n, np.int32)
    bp = sr.batch_pipeline
    w, nf, max_frames, ns = bp.to_device(wave, n_samples)
    n_frames = nf.cpu().numpy()
    stk.decode_batch(bp._post_core(w, nf, max_frames, ns), n_frames)
    events, host = [], {}

    def hook(stage):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((stage, ev))
        # the host's wall since the last hook (it returns before the card
        # has run the stage, unless the stage waits for the card)
        host[stage] = time.perf_counter()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    hook("start")
    lp = stk._xform(bp._post_core(w, nf, max_frames, ns))
    hook("posteriors")
    obs = dec.state_observations(lp)
    hook("state_obs")
    # the carry apart from the scan, so the host's walls show which of
    # the two waits for the card
    carry = dec.init_carry(dev, B)
    hook("init_carry")
    beam = OFF_BEAM if stk.beam_pruning is None else stk.beam_pruning
    recs = dec.scan_block(carry, obs, 0, nf, beam)[1]
    hook("netscan")
    walk = dec._traceback_batch(recs, nf)
    hook("nettrace")
    walk = [x.cpu().numpy() for x in walk]
    hook("fetch")
    labels = [dec.labels_from_edge_walk(*(x[b] for x in walk),
                                        int(n_frames[b])) for b in range(B)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    stages = {s: events[i - 1][1].elapsed_time(ev)
              for i, (s, ev) in enumerate(events) if i}
    stages["labels_host"] = wall * 1e3 - sum(stages.values())
    names = list(host)
    host_ms = {b: (host[b] - host[a]) * 1e3 for a, b in zip(names, names[1:])}
    peak = torch.cuda.max_memory_allocated(dev)
    again = stk.decode_batch(lp, n_frames)
    T = lp.shape[1]
    tb = dec.edge_tables(dev)
    k8 = {k: v[:8].contiguous() for k, v in recs.items()}
    _, rp = netscan.netscan_plain(dec.init_carry(dev, 8), obs[:8].contiguous(),
                                  _i32(np.zeros(8), dev), nf[:8].contiguous(),
                                  torch.full((8,), float(OFF_BEAM),
                                             device=dev), tb)
    wp = [x.cpu().numpy() for x in nettrace.nettrace_plain(
        rp, nf[:8].contiguous(), _i32(np.full(8, -1), dev), tb,
        dec.c.terminal_sink)]
    plain = [dec.labels_from_edge_walk(*(x[b] for x in wp), int(n_frames[b]))
             for b in range(8)]
    same_plain = [label_key(labels[b]) == label_key(plain[b]) and
                  all(_bits_equal(k8[k], rp[k]) for k in netscan.RECORDS)
                  for b in range(8)]
    same_again = [label_key(a) == label_key(b) for a, b in zip(labels, again)]
    phase("stk_batch", batch=B, seconds_each=5, frames=T,
          audio_s_per_s=B * 5 / wall, wall_s=wall, stage_ms=stages,
          host_ms=host_ms,
          netscan_clocks_a_frame=stages["netscan"] * 1e-3
          * clk["netscan"]["sm_clock_mhz"] * 1e6 / T,
          nettrace_clocks_a_step=stages["nettrace"] * 1e-3
          * clk["nettrace"]["sm_clock_mhz"] * 1e6 / T,
          max_memory_allocated_bytes=peak,
          labels_per_utt=float(np.mean([len(l) for l in labels])),
          plain_equal_rows=same_plain,
          decode_batch_equal=all(same_again))
    if not all(same_plain) or not all(same_again):
        raise AssertionError("stkint batch labels differ from the plain "
                             "versions or from decode_batch")


def traps_cli(pkg: str, name: str, tmp: str, dev, n: int = 16) -> dict:
    """n seeded int16 files of 1-8 s through the CLI with a 3BT, 1BT,
    1BT_DCT or PLP package (``--device cuda``): every file's labels equal
    the CPU port's (plain versions) on the same list, and kernel A is
    launched (with the band index for 3BT / 1BT).  Returns the launches."""
    from phnrec_tpu_torch import cli
    wav_dir = os.path.join(tmp, f"wav_{name}")
    os.makedirs(wav_dir)
    paths = synth.write_audio_files(wav_dir, n, (1.0, 8.0), seed=13)
    lst = os.path.join(tmp, f"list_{name}.scp")
    with open(lst, "w") as f:
        f.write("".join(p + "\n" for p in paths))
    mlf, ref = (os.path.join(tmp, f"{name}_{d}.mlf") for d in ("gpu", "cpu"))
    reset_counts(BATCH_KERNELS)
    before = mlp_fused.BAND_LAUNCHES
    t = time.perf_counter()
    rc = cli.main(["-c", pkg, "-l", lst, "-m", mlf, "--device", str(dev)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(read_counts(BATCH_KERNELS),
                    mlp_fused_bands=mlp_fused.BAND_LAUNCHES - before)
    if rc != 0:
        raise AssertionError(f"cli returned {rc}")
    SpeechRec(pkg, device="cpu").process_file_list("wf", "str", lst, ref)
    got, want = read_mlf(mlf), read_mlf(ref)
    same = list(got) == list(want) and all(
        label_key(got[k]) == label_key(want[k]) for k in want)
    bands = name in ("3BT", "1BT")
    phase("traps_cli", system=name, files=n,
          audio_s=sum(os.path.getsize(p) / 2 / 8000 for p in paths),
          wall_s=wall, labels=sum(len(v) for v in got.values()),
          launches=launches, cpu_labels_equal=same)
    if not same:
        raise AssertionError(f"{name}: CLI labels differ from the CPU port")
    if any(launches[k] == 0 for k in BATCH_KERNELS) or \
            (launches["mlp_fused_bands"] > 0) != bands:
        raise AssertionError(f"{name}: launches {launches}")
    return launches


def merger_batch(tsr, name: str, dev) -> int:
    """A timed batch of 256 x 5 s of a posterior system in the current
    precision mode (timed_batch), the split paths' counts set to 0 just
    before and read just after: the 3BT and 1BT mergers (past n_inp 480)
    must take the split path of the mode's kernel, the other systems'
    nets none.  Returns the mode's split-path launches."""
    reset_counts(WIDE_KERNELS)
    timed_batch(tsr, dev, B=256, name=f"batch_{name}")
    counts = read_counts(WIDE_KERNELS)
    phase("merger_launches", system=name, precision=precision.get_mode(),
          **counts)
    mine = "mlp_bf16x3_wide" if precision.get_mode() == "high" \
        else "mlp_fused_wide"
    if (counts[mine] > 0) != (name in ("3BT", "1BT")) or any(
            counts[k] for k in WIDE_KERNELS if k != mine):
        raise AssertionError(f"{name}: split-path launches {counts}")
    return counts[mine]


class ScanTimer:
    """CUDA events around every ``scan_block`` call of a NetworkDecoder
    while entered: kernel G's device ms over a run (the wrapper's small
    fills included), read after a synchronize."""

    def __init__(self, dec: NetworkDecoder):
        self.dec, self.pairs = dec, []

    def __enter__(self):
        orig = self.dec.scan_block

        def timed(*args, **kw):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            out = orig(*args, **kw)
            e.record()
            self.pairs.append((s, e))
            return out

        self.dec.scan_block = timed
        return self

    def __exit__(self, *exc) -> None:
        del self.dec.scan_block

    def ms(self) -> float:
        return sum(s.elapsed_time(e) for s, e in self.pairs)


def stk_streaming_vs_cpu(sr, cpu_sr, dev, seconds: float = 60.0,
                         chunk_s: float = 0.25, block: int = 128) -> dict:
    """StreamingRecognizer on the CZ stkint loop (decode mode): one
    stream of ``seconds`` fed in ``chunk_s`` chunks, blocks of ``block``
    frames, settled results polled every second; once with no commit (a
    horizon past the stream) and once with the default horizon, which
    commits.  The labels equal the CPU port's stream replayed block by
    block on the card's log-posteriors (kernels G bit-equal to its plain
    version, the same host walks and commits).  Returns the launches of
    the committing run."""
    rng = np.random.default_rng(41)
    raw = synth.synth_audio(rng, int(seconds * 8000)).astype("<i2").tobytes()
    chunk = int(chunk_s * 8000) * 2
    g_name = g_counter(sr.stk_decoder.decoder)
    names = ("mlp_fused", *G_KERNELS)
    out = {}
    for commits in (False, True):
        rec = StreamingRecognizer(sr, block_frames=block)
        if not commits:
            rec._stk_horizon = 10 ** 9
        lps, run = [], rec._run_stk_block
        rec._run_stk_block = lambda lp: (lps.append(lp.clone()), run(lp))
        peak, polls = 0, 0
        reset_counts(names)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with ScanTimer(sr.stk_decoder.decoder) as g_ms:
            for i in range(0, len(raw), chunk):
                rec.process(raw[i: i + chunk])
                if (i // chunk) % round(1 / chunk_s) == 0:
                    polls = len(rec.results(settled_only=True))
                peak = max(peak, rec._stk_retained())
            labels = rec.finish()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = read_counts(names)
        cpu = StreamingRecognizer(cpu_sr, block_frames=block)
        cpu._stk_horizon = rec._stk_horizon
        for lp in lps:
            cpu._decode(lp.cpu(), lp.shape[0])
        want = cpu.results()
        same = full_key(labels) == full_key(want)
        phase("stk_streaming_vs_cpu", seconds=seconds, chunk_s=chunk_s,
              block_frames=block, commits=commits,
              horizon=min(rec._stk_horizon, rec._n_decoded),
              frames=rec._n_decoded, blocks=len(lps), wall_s=wall,
              netscan_device_ms=g_ms.ms(),
              audio_s_per_s=seconds / wall, labels=len(labels),
              last_settled=polls, committed=rec.committed_count,
              peak_retained_rows=peak, launches=launches, cpu_equal=same)
        if not same or not labels:
            raise AssertionError("stkint streaming labels differ from the "
                                 "CPU port on the card's log-posteriors")
        if commits and (rec.committed_count == 0 or peak > rec._stk_horizon
                        + 2 * block):
            raise AssertionError(f"committed {rec.committed_count}, peak "
                                 f"{peak} rows")
        if launches[g_name] != len(lps) or launches["mlp_fused"] == 0 or \
                sum(launches[k] for k in G_KERNELS) != len(lps):
            raise AssertionError(f"launches {launches}")
        out = launches
    return out


def stk_live_kws_vs_cpu(sr, cpu_sr, dev, seconds: float = 30.0,
                        chunk_s: float = 0.25, block: int = 128) -> dict:
    """Live KWS through StreamingRecognizer (the EN KWS package): each
    block's sink records feed the recognizer's DeviceKWSTracker (kernel F
    at n = 1, the serving settings) and three more trackers with LRTrace's
    other settings; hits polled every chunk (kws_hits_so_far).  The
    recognizer's hits equal the CPU port's stream replayed on the card's
    log-posteriors, and every tracker's hits equal a CPU tracker's (F's
    plain version, same settings) on the card's sink records.  Returns
    the launches."""
    fs = sr.frontend.spec.sample_freq
    rng = np.random.default_rng(43)
    raw = synth.synth_audio(rng, int(seconds * fs), fs).astype(
        "<i2").tobytes()
    chunk = int(chunk_s * fs) * 2
    rec = StreamingRecognizer(sr, block_frames=block)
    stk = sr.stk_decoder
    c = stk.compiled
    kw = dict(word_sinks=c.kws_word_sinks, filler_sink=c.kws_filler_sink)
    trackers = {_setting(LRTRACE_SETTINGS[0]): rec._kws_tracker}
    for s in LRTRACE_SETTINGS[1:]:
        trackers[_setting(s)] = DeviceKWSTracker(
            stk.keywords(), stk.time_pruning, stk.kws_score_pruning, *s,
            device=dev, **kw)
    sinks, lps = [], []
    feed, run = rec._kws_tracker.feed_sinks, rec._run_stk_block

    def fan(sv, sw):
        sinks.append((sv.clone(), sw.clone()))
        feed(sv, sw)
        for k, tr in trackers.items():
            if tr is not rec._kws_tracker:
                tr.feed_sinks(sv, sw)

    rec._kws_tracker.feed_sinks = fan
    rec._run_stk_block = lambda lp: (lps.append(lp.clone()), run(lp))
    g_name = g_counter(stk.decoder)
    names = ("mlp_fused", *G_KERNELS, "lrtrace")
    reset_counts(names)
    live = []
    torch.cuda.synchronize()
    t = time.perf_counter()
    with ScanTimer(stk.decoder) as g_ms:
        for i in range(0, len(raw), chunk):
            rec.process(raw[i: i + chunk])
            live += rec.kws_hits_so_far()
        hits = rec.finish()
    live += rec.kws_hits_so_far()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    for tr in trackers.values():
        tr.finish()
    launches = read_counts(names)
    cpu = StreamingRecognizer(cpu_sr, block_frames=block)
    for lp in lps:
        cpu._decode(lp.cpu(), lp.shape[0])
    same = full_key(hits) == full_key(cpu.results()) and \
        label_key(live) == label_key(hits)
    per_setting = {}
    for name, tr in trackers.items():
        imp, q = LRTRACE_SETTINGS[[_setting(s) for s in
                                   LRTRACE_SETTINGS].index(name)]
        ref = DeviceKWSTracker(stk.keywords(), stk.time_pruning,
                               stk.kws_score_pruning, imp, q, device="cpu",
                               **kw)
        for sv, sw in sinks:
            ref.feed_sinks(sv.cpu(), sw.cpu())
        ref.finish()
        per_setting[name] = dict(hits=len(tr.hits), cpu_equal=[
            vars(h) for h in tr.hits] == [vars(h) for h in ref.hits])
    phase("stk_live_kws_vs_cpu", seconds=seconds, chunk_s=chunk_s,
          block_frames=block, keywords=stk.keywords(), blocks=len(lps),
          wall_s=wall, netscan_device_ms=g_ms.ms(),
          audio_s_per_s=seconds / wall, hits=len(hits),
          live_hits=len(live), launches=launches, cpu_equal=same,
          settings=per_setting)
    if not same or not all(v["cpu_equal"] for v in per_setting.values()):
        raise AssertionError("live KWS hits differ from the CPU port")
    if launches["lrtrace"] != len(LRTRACE_SETTINGS) * len(lps) or \
            launches[g_name] != len(lps) or \
            sum(launches[k] for k in G_KERNELS) != len(lps):
        raise AssertionError(f"launches {launches}, {len(lps)} blocks")
    return launches


def stk_kws_files(en_sr, en_cpu, tmp, dev, n: int = 8) -> dict:
    """n EN files of 4-20 s through SpeechRec.process_file_list on the
    card (the KWS package), each batch's log-posteriors captured: the CPU
    port decoding the card's log-posteriors gives the card's hits."""
    fs = en_sr.cfg.get_int("source", "sample_freq")
    rng = np.random.default_rng(15)
    d = os.path.join(tmp, "en_wav")
    os.makedirs(d)
    paths = []
    for i in range(n):
        p = os.path.join(d, f"e{i}.raw")
        with open(p, "wb") as f:
            f.write(synth.synth_audio(rng, int(rng.uniform(4, 20) * fs), fs)
                    .astype("<i2").tobytes())
        paths.append(p)
    lst = os.path.join(tmp, "en_list.scp")
    with open(lst, "w") as f:
        f.write("".join(p + "\n" for p in paths))
    seen = []
    stk = en_sr.stk_decoder
    orig = stk.decode_batch

    def spy(lp, n_frames):
        out = orig(lp, n_frames)
        seen.append((lp.cpu(), np.asarray(n_frames), out))
        return out

    stk.decode_batch = spy
    names = ("mlp_fused", g_counter(stk.decoder))
    reset_counts(names)
    try:
        en_sr.process_file_list("wf", "str", lst,
                                os.path.join(tmp, "en.mlf"))
        torch.cuda.synchronize()
    finally:
        del stk.decode_batch
    launches = read_counts(names)
    same, hits = [], 0
    for lp, nf, out in seen:
        want = en_cpu.stk_decoder.decode_batch(lp, nf)
        same.append([[vars(l) for l in r] for r in out] ==
                    [[vars(l) for l in r] for r in want])
        hits += sum(map(len, out))
    phase("stk_kws_files", files=n, batches=len(seen), hits=hits,
          hits_equal=same, launches=launches)
    if not all(same) or not hits or not all(launches.values()):
        raise AssertionError(f"KWS file hits differ from the CPU port's "
                             f"({same}, {hits} hits, {launches})")
    return launches


# ---------------------------------------------------------------------------
# stkint decode serving: kernel E (netdecode), H's int16 instance, the
# MultiStreamStkDecode server; KWS serving with an InputXform and on G
# ---------------------------------------------------------------------------
def _netdecode_inputs(dense, dev, n, F, seed, ties=False, dead=False):
    """Kernel E's inputs: obs [n, F, E] (normal, or small integers that tie
    many candidates), ragged n_valid (all 0 with ``dead``), the initial
    decode carry."""
    rng = np.random.default_rng(seed)
    obs = (rng.integers(-3, 1, (n, F, dense.E)) if ties else
           rng.normal(-3, 2, (n, F, dense.E))).astype(np.float32)
    nv = rng.integers(1, F + 1, n)
    nv[::7] = 0
    nv[1::5] = F
    if dead:
        nv[:] = 0
    return (dense.init_carry_decode(n, dev), torch.from_numpy(obs).to(dev),
            _i32(nv, dev))


def _id_dtype(dense):
    """int16 where every edge id fits, as MultiStreamStkDecode keeps them."""
    top = max(int(getattr(dense, k).max()) for k in ("I_in", "I_ex", "I_cm",
                                                     "I_cs"))
    return torch.int16 if top < 1 << 15 else torch.int32


def _netdecode_work(dense, nv: torch.Tensor, n: int, F: int) -> tuple:
    """(bytes, operations) of a block: the live frames' observations read,
    every frame's records written (ids at 2 bytes), the carry read and
    written; per live frame and stream ~7 operations a state (three
    candidates, the observation, the beam max), one a model exit, two a
    live closure or sink edge."""
    E, M, S = dense.E, dense.M, dense.n_sinks
    live_rows = int(nv.sum())
    nnz = int((dense.A_cm > NEG / 2).sum()
              + (dense.A_cs[:, :S] > NEG / 2).sum())
    rec_row = 2 * E + 3 * 2 * M + 4 * M + 6 * S
    n_bytes = live_rows * E * 4 + n * F * rec_row + 2 * n * (E + 2 * M) * 4 \
        + n * 8
    return n_bytes, live_rows * (7 * E + M + 2 * nnz)


def _netdecode_err(got, want) -> float:
    """The largest |kernel - plain| over the values live in the plain
    version's output: the records' entry_val and sink_val, the carry's
    alpha and entry."""
    (ck, rk), (cp, rp) = got, want
    err = 0.0
    for g, w in ((rk["entry_val"], rp["entry_val"]),
                 (rk["sink_val"], rp["sink_val"]), (ck[0], cp[0]),
                 (ck[1], cp[1])):
        live = w > NEG / 2
        if live.any():
            err = max(err, float((g - w).abs()[live].max()))
    return err


def check_netdecode(nets: dict, cz_dec, dev, n: int = 256,
                    F: int = 512) -> dict:
    """Kernel E against its plain version (the step_decode loop) on the
    card: every value live where the plain one is and bit-equal there, every
    id equal where its value is live (netdecode.compare_live), beam off
    and 6.0, on: the CZ stkint loop at n 256 x F 512 (timed: both timers,
    clocks a frame, bound) with normal and tie-heavy observations; the EN
    KWS net; synth.dense_kws_net nets of 96 x 2 (tables in shared memory
    past 48 KB) and 340 x 3 (1,020 states, tables in device memory, int32
    ids); the CZ loop with int32 ids (its instance rounds the states a
    lane up to a power of two); n 1 and 13 (no multiple of the 4 streams
    a block); every stream dead; a carry passed between two blocks, which
    must equal one; both instances (redux: the CZ loop; general: the EN
    KWS and wide nets) must be reached.  max_abs_err: the largest |kernel
    - plain| over the live values (entry_val, sink_val, the carry's alpha
    and entry) of every case and beam, 0 where they are bit-equal.  Then kernel H's
    int16 instance on E's records of the CZ case: equal to the
    plain walk over E's records and over the plain version's (a dead
    entry's id never reaches a walk), with and without committed
    boundaries, on both paths, and timed beside the int32 instance on the
    same records.  Returns E's result and H's int16 timing."""
    cases = {"cz_main": ("cz", n, F, dict(seed=71)),
             "cz_ties": ("cz", n, F, dict(seed=72, ties=True)),
             "en_kws": ("en", 64, F, dict(seed=73)),
             "n1": ("cz", 1, 200, dict(seed=74)),
             "n13": ("cz", 13, 200, dict(seed=75, ties=True)),
             "all_dead": ("cz", 16, 64, dict(seed=76, dead=True)),
             "two_blocks": ("cz", 32, 300, dict(seed=77)),
             "cz_int32": ("cz", 32, 128, dict(seed=80, ids=torch.int32)),
             "wide_smem": ("wide_smem", 6, 48, dict(seed=78)),
             "wide_global": ("wide_global", 6, 48, dict(seed=79,
                                                        ties=True))}
    blks = {k: netdecode.build_net_decode_fn(v) for k, v in nets.items()}
    if None in blks.values():
        raise AssertionError(f"the structure gate rejected a net: {blks}")
    out, bad, h16, err = None, [], None, 0.0
    instances = set()
    for case, (net, cn, cF, kw) in cases.items():
        dense, blk = nets[net], blks[net]
        kw = dict(kw)
        ids = kw.pop("ids", None) or _id_dtype(dense)
        carry0, obs, nv = _netdecode_inputs(dense, dev, cn, cF, **kw)
        for bw in (float(OFF_BEAM), 6.0):
            beam = torch.full((cn,), bw, device=dev)
            args = (carry0, obs, nv, beam)
            got = blk(*args, id_dtype=ids)
            want = netdecode.net_decode_block_plain(dense, *args, ids,
                                                    values=True)
            torch.cuda.synchronize()
            checks = netdecode.compare_live(got, want)
            if case == "two_blocks":
                h = cF // 2 - 3
                c1, r1 = blk(carry0, obs[:, :h].contiguous(),
                             nv.clamp(max=h), beam, ids)
                c2, r2 = blk(c1, obs[:, h:].contiguous(),
                             (nv - h).clamp(min=0), beam, ids)
                two = (c2, {k: torch.cat([r1[k], r2[k]], 1) for k in r1})
                checks["two_equal_one"] = all(
                    torch.equal(a, b) for a, b in zip(two[0], got[0])) and \
                    all(torch.equal(two[1][k], got[1][k]) for k in two[1])
            case_err = _netdecode_err(got, want)
            err = max(err, case_err)
            rec = dict(case=case, n=cn, F=cF, M=dense.M, E=dense.E,
                       S=dense.n_sinks, distinct_columns=blk.U, beam=bw,
                       ids=str(ids).split(".")[-1],
                       instance=blk.instance(ids),
                       live_entry_share=float(
                           (want[1]["entry_val"] > NEG / 2).float().mean()),
                       bit_equal=all(checks.values()),
                       max_abs_err_live=case_err)
            if case == "cz_main" and bw == float(OFF_BEAM):
                fn = lambda: blk(*args, id_dtype=ids)  # noqa: E731
                t_k = cuda_ms(fn)
                held = scan_variants.held_ms(fn)
                t_p = cuda_ms(lambda: netdecode.net_decode_block_plain(
                    dense, *args, ids), iters=2, warmup=1)
                mhz = sm_clock(fn, max(t_k, 0.2))
                bnd = bound(*_netdecode_work(dense, nv, cn, cF), PEAK_FP32)
                out = dict(ms=t_k, held_ms=held,
                           plain_ms=t_p, sm_clock_mhz=mhz,
                           clocks_a_frame=held * 1e-3 * mhz * 1e6 / cF,
                           bound_share=bnd["bound_ms"] / held, **bnd)
                rec.update(out)
                h16 = check_nettrace_i16(cz_dec, got, want, nv, dev)
            phase("netdecode", **rec)
            instances.add(rec["instance"])
            if not all(checks.values()):
                bad.append((case, bw, {k: v for k, v in checks.items()
                                       if not v}))
    if bad:
        raise AssertionError(f"netdecode differs from the plain version: "
                             f"{bad}")
    if instances != {"redux", "general"}:
        raise AssertionError(f"the case list missed an instance of kernel "
                             f"E: {instances}")
    # over every case and beam: the live values' largest difference
    out["max_abs_err"] = err
    return out, h16


def _walk_bits_equal(a, b) -> bool:
    return all(_bits_equal(x, y) for x, y in zip(a, b))


def _walk_live_equal(a, b) -> bool:
    """Two walks equal in everything a label reads: ok, the sink value,
    the crossed edges and their values, and the sink edge of the rows that
    reach the terminal sink (a row that does not gives no labels, and its
    sink edge is the id of a dead entry)."""
    ok = a[0]
    return _bits_equal(a[0], b[0]) and _bits_equal(a[2], b[2]) and \
        _bits_equal(a[3], b[3]) and _bits_equal(a[4], b[4]) and \
        torch.equal(torch.where(ok, a[1], 0), torch.where(ok, b[1], 0))


def check_nettrace_i16(dec, got, want, nv, dev) -> dict:
    """Kernel H's int16 instance on kernel E's records (CZ loop): equal to
    the plain walk over the same records and over the plain version's
    records, frame0 none and committed, shared and device-memory paths;
    held ms and clocks a step beside the int32 instance on the same
    records cast to int32."""
    rk, rp = got[1], want[1]
    B, T = rk["in_am"].shape[:2]
    tb = dec.edge_tables(dev)
    ts = dec.c.terminal_sink
    res, ok = {}, True
    for committed in (False, True):
        f0 = np.full(B, -1, np.int32)
        if committed:
            f0[1::2] = np.random.default_rng(81).integers(0, T, B)[1::2]
        f0 = _i32(f0, dev)
        walk_k = nettrace.nettrace(rk, nv, f0, tb, ts)
        walk_g = nettrace.launch(nettrace._lib(), rk, nv, f0, tb, ts,
                                 force_global=True)
        plain_k = nettrace.nettrace_plain(rk, nv, f0, tb, ts)
        plain_p = nettrace.nettrace_plain(rp, nv, f0, tb, ts)
        torch.cuda.synchronize()
        same = {f"{'committed' if committed else 'none'}_{k}": eq(x, y)
                for k, (x, y, eq) in (
                    ("kernel_vs_plain", (walk_k, plain_k, _walk_bits_equal)),
                    ("global_vs_plain", (walk_g, plain_k, _walk_bits_equal)),
                    ("e_vs_plain_records", (walk_k, plain_p,
                                            _walk_live_equal)))}
        res.update(same)
        ok &= all(same.values())
        if not committed:
            res["rows_ok"] = int(walk_k[0].sum())
            res["crossings"] = int((walk_k[3] >= 0).sum())
    f0 = _i32(np.full(B, -1), dev)
    r32 = {k: (v.to(torch.int32) if k in netdecode.ID_KEYS else v)
           for k, v in rk.items()}
    for name, recs in (("int16", rk), ("int32", r32)):
        fn = lambda r=recs: nettrace.nettrace(r, nv, f0, tb,  # noqa: E731
                                              ts)
        held = scan_variants.held_ms(fn)
        mhz = sm_clock(fn, max(held, 0.2))
        res[f"{name}_held_ms"] = held
        res[f"{name}_clocks_a_step"] = held * 1e-3 * mhz * 1e6 / T
    res["B"], res["T"] = B, T
    phase("nettrace_int16", **res)
    if not ok or not res["rows_ok"]:
        raise AssertionError(f"kernel H's int16 instance differs: {res}")
    return res


class _SDCapture(MultiStreamStkDecode):
    """Records each block's log-posteriors as the decoder receives them."""

    def __init__(self, *a, **kw):
        self.lps = []
        super().__init__(*a, **kw)

    def _decode_block(self, carry, lp, n_dec, n_valid):
        self.lps.append(lp.cpu())
        return super()._decode_block(carry, lp, n_dec, n_valid)


class _SDReplay(MultiStreamStkDecode):
    """Decodes given log-posteriors instead of its own, after measuring
    its own against them on the valid rows."""

    def __init__(self, lps, *a, **kw):
        self.lps, self.err = list(lps), 0.0
        super().__init__(*a, **kw)

    def _decode_block(self, carry, lp, n_dec, n_valid):
        given = self.lps.pop(0)
        rows = torch.arange(lp.shape[1])[None, :] < n_valid.cpu()[:, None]
        if rows.any():
            self.err = max(self.err, float((given - lp).abs()[rows].max()))
        return super()._decode_block(carry, given, n_dec, n_valid)


def stk_serving_vs_cpu(sr, cpu_sr, dev, n: int = 4, seconds: float = 10.0,
                       horizon: int = 256):
    """stkint decode serving on the card against the CPU port (plain
    versions): 4 streams of 10, 9, 8, 7 s of the CZ stkint loop fed in 2 s
    chunks through MultiStreamStkDecode.process(), blocks of 512 frames;
    the CPU port decodes the card's log-posteriors and must give the
    card's labels exactly (names, boundaries, scores), its own
    log-posteriors within TOL_PHN_LP of the card's.  Again with
    record_horizon 256, so the fixed-lag commit runs every block: the
    committed prefixes and the labels equal the CPU port's."""
    rng = np.random.default_rng(91)
    streams = [synth.synth_audio(rng, int((seconds - i) * 8000))
               .astype("<i2").tobytes() for i in range(n)]

    rec = {}
    for name, kw in (("full", {}), ("commit", dict(record_horizon=horizon))):
        reset_counts(STK_SERVE_KERNELS)
        gpu = _SDCapture(sr, n, block_frames=512, **kw)
        got = _feed_chunks(gpu, streams)
        torch.cuda.synchronize()
        launches = read_counts(STK_SERVE_KERNELS)
        cpu = _SDReplay(gpu.lps, cpu_sr, n, block_frames=512, **kw)
        want = _feed_chunks(cpu, streams)
        same = [full_key(a) == full_key(b) for a, b in zip(got, want)]
        committed = [full_key(a) == full_key(b) for a, b in
                     zip(gpu._stk_committed, cpu._stk_committed)]
        rec[name] = dict(launches=launches, net_path=gpu.net_path,
                         labels=[len(x) for x in got], labels_equal=same,
                         committed=[len(c) for c in gpu._stk_committed],
                         committed_equal=committed,
                         max_lp_err_cpu_vs_card=cpu.err)
        # the streams end at different frames, so the last blocks are
        # ragged and the final walk runs on the host; the commit run walks
        # the first, uniform, blocks on the card (kernel H)
        need = STK_SERVE_KERNELS if name == "commit" else \
            ("mlp_fused", "netdecode")
        if gpu.net_path != "kernel_e" or not all(launches[k] for k in need):
            raise AssertionError(f"stk serving skipped a kernel: {rec}")
        if not all(same) or not all(committed) or not all(got) or \
                not cpu.err <= TOL_PHN_LP:
            raise AssertionError(f"card stk serving differs from the CPU "
                                 f"port's: {rec}")
    if not all(rec["commit"]["committed"]):
        raise AssertionError(f"a stream committed nothing: {rec}")
    phase("stk_serving_vs_cpu", streams=n, seconds=seconds, block_frames=512,
          record_horizon=horizon, tol_lp=TOL_PHN_LP, **rec)


def stk_serving(sr, dev, n: int = 256, n_blocks: int = 12,
                block: int = 512, runs: int = 2) -> dict:
    """MultiStreamStkDecode over n streams x 12 blocks of 512 frames
    (61.44 s at 8 kHz) of the CZ stkint loop staged on the card as int16,
    one decode_device_buffer call a block (as a server drains its buffer)
    with the default record horizon, so the fixed-lag commit walks (kernel
    H) and drops blocks as it goes, then finish(): launch counts of one
    run, whose walks are then held to the plain walk on the same windows
    (check_serving_walks), then the median of ``runs`` timed runs after a
    warm-up, with CUDA-event stage times.  Returns the launch counts and
    the walks' summary."""
    fs = sr.cfg.get_int("source", "sample_freq")
    audio, L = _serving_audio(sr, dev, n, n_blocks, block)

    def one_pass(hook=None):
        t = time.perf_counter()
        ms = MultiStreamStkDecode(sr, n, block_frames=block)
        ms.stage_hook = hook
        if hook:
            hook("start")
        retained = []
        for k in range(n_blocks):
            ms.decode_device_buffer(audio, 1, first_block=k)
            retained.append(len(ms._hist))
        torch.cuda.synchronize()
        t_dev = time.perf_counter()
        labels = ms.finish()
        torch.cuda.synchronize()
        return ms, labels, retained, t_dev - t, time.perf_counter() - t_dev

    # the counted run keeps each window kernel H walks (the commits' and
    # finish()'s) with the walk, to hold them to the plain walk after it
    walks = []
    real = nettrace.nettrace

    def spy(recs, nv, f0, *a):
        w = real(recs, nv, f0, *a)
        walks.append(((recs, nv, f0, *a), w))
        return w

    one_pass()                                   # warm-up
    nettrace.nettrace = spy
    reset_counts(STK_SERVE_KERNELS)
    try:
        ms, labels, retained, _, _ = one_pass()
    finally:
        nettrace.nettrace = real
    launches = read_counts(STK_SERVE_KERNELS)
    serving_walks = check_serving_walks(walks)
    del walks
    # 3 nets a block and the tail flush; E a block and the flush
    if launches["mlp_fused"] != 3 * (n_blocks + 1) or \
            launches["netdecode"] != n_blocks + 1 or \
            not launches["nettrace"] or ms.net_path != "kernel_e":
        raise AssertionError(f"stk serving launches: {launches}")
    if ms._frame0.min() <= 0 or not all(ms._stk_committed) or \
            max(retained) > -(-ms._horizon // block) + 2:
        raise AssertionError(f"the commit did not bound the window: "
                             f"{retained}, frame0 {ms._frame0.min()}")
    if sum(1 for x in labels if len(x) > 10) < n:
        raise AssertionError("a stream decoded too few labels")

    walls, stage_runs, host_runs, devs, fins = [], [], [], [], []
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(runs):
        events, host = [], []

        def hook(stage):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((stage, ev))
            host.append(time.perf_counter())

        torch.cuda.synchronize()
        t = time.perf_counter()
        _, _, _, dev_s, fin_s = one_pass(hook)
        walls.append(time.perf_counter() - t)
        devs.append(dev_s)
        fins.append(fin_s)
        st, hs = {}, {}
        for i in range(1, len(events)):
            name = events[i][0]
            st[name] = st.get(name, 0.0) + \
                events[i - 1][1].elapsed_time(events[i][1])
            hs[name] = hs.get(name, 0.0) + (host[i] - host[i - 1]) * 1e3
        stage_runs.append(st)
        host_runs.append(hs)
    peak = torch.cuda.max_memory_allocated(dev)
    busy = device_busy_share(lambda: one_pass(), kernels=True)
    wall = float(np.median(walls))
    names = ("posteriors", "netdecode", "compact", "walk", "fetch", "commit")
    # CUDA events at the hooks: a stage's device time and any time the
    # card idled in it waiting for the host (the commits' host work shows
    # in the next block's posteriors); the host's walls between the hooks
    # (the commit: labels_from_edge_walk and the bookkeeping)
    stages = {k: float(np.median([r.get(k, 0.0) for r in stage_runs]))
              for k in names}
    host_ms = {k: float(np.median([r.get(k, 0.0) for r in host_runs]))
               for k in names}
    stages["blocks_wall"] = float(np.median(devs)) * 1e3
    stages["finish"] = float(np.median(fins)) * 1e3
    phase("stk_serving", streams=n, seconds_each=L / fs, blocks=n_blocks,
          block_frames=block, record_horizon=ms._horizon,
          launches=launches, net_path=ms.net_path,
          retained_blocks=retained,
          committed_labels=sum(map(len, ms._stk_committed)),
          labels_total=sum(map(len, labels)), wall_s=walls,
          audio_s_per_s=n * L / fs / wall, stage_ms=stages, host_ms=host_ms,
          max_memory_allocated_bytes=peak, device_busy_share=busy)
    return launches, serving_walks


def check_serving_walks(walks) -> dict:
    """Kernel H's int16 instance on the windows stk_serving's counted run
    walked, at the shapes the main path gave it (the commits' B 256 x T
    ~2,560 and finish()'s): each walk bit-equal to the plain walk over the
    same records, n_valid and frame0.  Among them a walk from the stream
    starts (every frame0 -1) and walks with committed boundaries."""
    out = []
    for args, walk in walks:
        recs, nv, f0 = args[:3]
        plain = nettrace.nettrace_plain(*args)
        torch.cuda.synchronize()
        out.append(dict(
            B=int(nv.shape[0]), T=int(recs["in_am"].shape[1]),
            ids=str(recs["in_am"].dtype).split(".")[-1],
            committed_rows=int((f0 >= 0).sum()),
            rows_ok=int(walk[0].sum()), crossings=int((walk[3] >= 0).sum()),
            equal=_walk_bits_equal(walk, plain)))
    phase("nettrace_serving_walks", walks=out)
    if not out or not all(w["equal"] and w["ids"] == "int16" and w["rows_ok"]
                          for w in out) or \
            not any(w["committed_rows"] == 0 for w in out) or \
            not any(w["committed_rows"] for w in out):
        raise AssertionError(f"kernel H's int16 walks on the serving "
                             f"windows differ from the plain walk, or a "
                             f"kind of walk is missing: {out}")
    return dict(walks=len(out), max_T=max(w["T"] for w in out),
                equal=True)


def _phnloop_fb_work(B: int, T: int, P: int, S: int, D: int) -> tuple:
    """(bytes, operations) of kernel J: log_post read, alpha and beta
    written once; about 20 operations a state a frame each way (two
    logaddexps of ~6, the adds, the per-frame lse's share)."""
    return 4 * (B * T * D + 2 * B * T * P * S + B), 40 * B * T * P * S


def _graph_fb_work(S: int, T: int, ns, align: bool = False) -> tuple:
    """(bytes, operations) of kernel K (or K') over this run's frames:
    log_A, log_b, entry and exit read once, alpha and beta (the states)
    written once; per live frame and utterance S^2 lse terms of ~6
    operations each way (K), or one add and one compare (K')."""
    B, n = len(ns), int(np.sum(ns))
    reads = 4 * (B * S * S + B * T * S + 2 * B * S)
    if align:
        return reads + 4 * (B * T + B), 2 * S * S * n
    return reads + 4 * (2 * B * T * S + B), 12 * S * S * n


def check_trainfb_cases(dev, models) -> dict:
    """Kernels J, K and K' against their plain versions on the card, on
    devtools/trainfb_variants.py's case list (J: loops of 4 x 3 to 2,100 x
    3 states, past 1,024 threads and with its carries in device memory, B
    1 and 16; K and K': padded training graphs of ``models`` at S 32 to
    6,304, B 1 to 160, ragged n_frames, ties; each case on the design the
    plan gives it, clusters up to S 928 and one block an utterance past
    it), J and K within its TOL relative (of max(|x|, 1)), K' bit for
    bit; the one-block K and K' held the same way on every case (at the
    training bucket B 16 x T 512 x S 256 too), and K on a cluster compared
    bit for bit with the one-block K (reported).  Then each is timed at
    the training path's shapes (J: one CZ utterance of 500 frames; K, K':
    a bucket of 16 x 512 frames x 256 states, on its cluster and one block
    an utterance), with the clusters the card holds at once by size."""
    lib = trainfb._lib()
    res = trainfb_variants.check_cases(
        phnloop_fb.phnloop_fb, trainfb.graph_fb, trainfb.graph_align, dev,
        models, fb_one=lambda *a: trainfb.launch_fb(lib, *a, cluster=0),
        align_one=lambda *a: trainfb.launch_align(lib, *a, cluster=0),
        j_block=lambda *a: phnloop_fb.launch(lib, *a, instance="block"),
        j_instance=phnloop_fb.plan_instance)
    err = {"graph_fb": 0.0, "graph_fb_cluster": 0.0}
    for r in res["cases"]:
        if r["kernel"] == "graph_fb+graph_align":
            r["cluster"] = trainfb.plan(lib, False, r["B"], r["S"], dev)
            r["align_cluster"] = trainfb.plan(lib, True, r["B"], r["S"], dev)
            k = "graph_fb_cluster" if r["cluster"] else "graph_fb"
            err[k] = max(err[k], r["abs_err"])
            err["graph_fb"] = max(err["graph_fb"], r["one_block_abs_err"])
    paths = {w: sorted({r[w] for r in res["cases"] if w in r})
             for w in ("cluster", "align_cluster", "instance")}
    # J's largest |kernel - plain| by instance: the planned one, and the
    # block instance forced on every case
    j_recs = [r for r in res["cases"] if r["kernel"] == "phnloop_fb"]
    j_err = {"group": max(r["abs_err"] for r in j_recs
                          if r["instance"] == "group"),
             "block": max(max(r["block_abs_err"] for r in j_recs),
                          max(r["abs_err"] for r in j_recs
                              if r["instance"] == "block"))}
    phase("trainfb_cases", tol=trainfb_variants.TOL, paths=paths, **res)
    if not res["ok"]:
        raise AssertionError(f"kernel J, K or K' differs: {res}")
    if not all(0 in paths[w] and len(paths[w]) > 1
               for w in ("cluster", "align_cluster")) or \
            paths["instance"] != ["block", "group"]:
        raise AssertionError(f"the case list missed a design: {paths}")
    inp = trainfb_variants.timing_inputs(dev, models)
    ns, k = inp["ns"], inp["k"]
    B, T, S = k[3].shape
    active = {w: trainfb.max_active(lib, w == "graph_align", S, dev)
              for w in ("graph_fb", "graph_align")}
    plain = {"graph_fb": lambda: trainfb.graph_fb_plain(*k),
             "graph_align": lambda: trainfb.graph_align_plain(*k)}
    plain_ms = {w: cuda_ms(f, iters=1, warmup=1) for w, f in plain.items()}
    out = {}
    j_plain = cuda_ms(lambda: phnloop_fb.phnloop_fb_plain(*inp["j"]),
                      iters=1, warmup=1)
    for name, fn, t_p, work, err_k in (
            ("phnloop_fb", lambda: phnloop_fb.launch(lib, *inp["j"],
                                                     instance="block"),
             j_plain, _phnloop_fb_work(1, 500, 46, 3, 138),
             j_err["block"]),
            ("phnloop_fb_group", lambda: phnloop_fb.phnloop_fb(*inp["j"]),
             j_plain, _phnloop_fb_work(1, 500, 46, 3, 138),
             j_err["group"]),
            ("graph_fb", lambda: trainfb.launch_fb(lib, *k, cluster=0),
             plain_ms["graph_fb"], _graph_fb_work(S, T, ns),
             err["graph_fb"]),
            ("graph_align", lambda: trainfb.launch_align(lib, *k, cluster=0),
             plain_ms["graph_align"], _graph_fb_work(S, T, ns, align=True),
             0.0),
            ("graph_fb_cluster", lambda: trainfb.graph_fb(*k),
             plain_ms["graph_fb"], _graph_fb_work(S, T, ns),
             err["graph_fb_cluster"]),
            ("graph_align_cluster", lambda: trainfb.graph_align(*k),
             plain_ms["graph_align"], _graph_fb_work(S, T, ns, align=True),
             0.0)):
        t_k = cuda_ms(fn, iters=5, warmup=1)
        held = scan_variants.held_ms(fn, iters=5, warmup=1)
        out[name] = dict(max_abs_err=err_k, ms=t_k, held_ms=held,
                         plain_ms=t_p, **bound(*work, PEAK_FP32))
        out[name]["bound_share"] = out[name]["bound_ms"] / held
    for name in J_KERNELS:
        out[name]["shape"] = "B 1 x T 500 x P 46 x S 3"
        out[name]["step_clocks"] = clocks(
            lambda: phnloop_fb.launch(lib, *inp["j"], instance=(
                "group" if name.endswith("group") else "block")),
            out[name]["held_ms"], 2 * 500)
    for name in GRAPH_KERNELS:
        align = name.startswith("graph_align")
        w = "graph_align" if align else "graph_fb"
        out[name].update(
            shape=f"bucket B {B} x T {T} x S {S}, n 385-512",
            step_us=out[name]["held_ms"] * 1e3 / (T if align else 2 * T),
            cluster=(trainfb.plan(lib, align, B, S, dev)
                     if name.endswith("cluster") else 0),
            max_active=active[w])
    phase("trainfb_timing", **out)
    return out


def staged_cli(pkg: str, tmp: str, cpu_sr, dev, n: int = 16) -> dict:
    """n CZ files through the CLI as -t par, -s par -t post and -s post -t
    str (``--device cuda``): the labels equal wf -> str's (the CLI's
    batched list), and the par and post files equal the CPU port's within
    TOL_PHN_LP.  Returns the launches of the staged runs."""
    from phnrec_tpu_torch import cli
    from phnrec_tpu_torch.io import htk
    d = os.path.join(tmp, "staged")
    os.makedirs(d)
    paths = synth.write_audio_files(d, n, (1.0, 8.0), seed=17)
    stems = [os.path.splitext(p)[0] for p in paths]

    def run(inpf, outpf, sources, mlf=None):
        lst = os.path.join(d, f"{inpf}_{outpf}.scp")
        with open(lst, "w") as f:
            for s, st in zip(sources, stems):
                f.write(f"{s}\n" if outpf == "str" else f"{s} {st}.{outpf}\n")
        argv = ["-c", pkg, "-s", inpf, "-t", outpf, "-l", lst,
                "--device", str(dev)]
        rc = cli.main(argv + (["-m", mlf] if mlf else []))
        if rc != 0:
            raise AssertionError(f"cli -s {inpf} -t {outpf} returned {rc}")

    reset_counts(BATCH_KERNELS)
    t = time.perf_counter()
    run("wf", "par", paths)
    run("par", "post", [s + ".par" for s in stems])
    staged_mlf, batch_mlf = (os.path.join(d, f"{k}.mlf")
                             for k in ("staged", "batch"))
    run("post", "str", [s + ".post" for s in stems], staged_mlf)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = read_counts(BATCH_KERNELS)
    run("wf", "str", paths, batch_mlf)
    got, want = read_mlf(staged_mlf), read_mlf(batch_mlf)
    same = list(got) == list(want) and all(
        label_key(got[k]) == label_key(want[k]) for k in want)
    errs = {"par": 0.0, "post": 0.0}
    for p, st in zip(paths, stems):
        par = cpu_sr.params_from_waveform(open(p, "rb").read())
        post = cpu_sr.posteriors_from_params(htk.read_htk(st + ".par")[0])
        for k, ref in (("par", par), ("post", post)):
            card = htk.read_htk(f"{st}.{k}")[0]
            if card.shape != ref.shape:
                raise AssertionError(f"{k} shape {card.shape} != {ref.shape}")
            errs[k] = max(errs[k], float(np.abs(card - ref).max()))
    phase("staged_cli", files=n, wall_s=wall, launches=launches,
          labels=sum(len(v) for v in got.values()),
          labels_equal_wf_str=same, max_abs_err_vs_cpu=errs,
          tol=TOL_PHN_LP)
    if not same:
        raise AssertionError("staged labels differ from wf -> str")
    if max(errs.values()) > TOL_PHN_LP:
        raise AssertionError(f"staged files differ from the CPU port: {errs}")
    if any(v == 0 for v in launches.values()):
        raise AssertionError(f"staged launches {launches}")
    return launches


SETUP_STEPS = ("compile_transcription", "pad_graph", "stack_graphs")


def _time_setup(re_, host: dict):
    """Host timers on the graph work of Reestimator ``re_``, summed in ms
    into ``host``: train/loop.py's compile_transcription, pad_graph and
    stack_graphs, and the rest of each bucket flush up to its
    bucket_setup mark (``numpy_padding``: the observations' numpy pad and
    the small tensors).  Returns the function that undoes the patches."""
    from phnrec_tpu_torch.train import loop
    saved = {k: getattr(loop, k) for k in SETUP_STEPS}
    for k in (*SETUP_STEPS, "flush_to_mark"):
        host.setdefault(k, 0.0)

    def timed(name, fn):
        def call(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                host[name] += (time.perf_counter() - t) * 1e3
        return call
    for k, fn in saved.items():
        setattr(loop, k, timed(k, fn))
    flush = re_._flush_bucket
    start = [0.0]

    def timed_flush(key):
        start[0] = time.perf_counter()
        flush(key)
    re_._flush_bucket = timed_flush
    hook = re_.stage_hook

    def mark(stage):
        if stage == "bucket_setup":
            host["flush_to_mark"] += (time.perf_counter() - start[0]) * 1e3
        if hook is not None:
            hook(stage)
    re_.stage_hook = mark

    def undo():
        for k, fn in saved.items():
            setattr(loop, k, fn)
        host["numpy_padding"] = host.pop("flush_to_mark") - \
            host["pad_graph"] - host["stack_graphs"]
    return undo


def _reestimate(models, utts, mode, dev, stages=None, host=None,
                stage_host=None, buckets=None) -> tuple:
    """One accumulation pass of a Reestimator over ``utts`` ((x, names)
    pairs) on ``dev``: (accumulators, total log-likelihood, wall s).
    ``stages`` (a dict) collects the card's ms by stage from CUDA events
    at the Reestimator's hooks, ``stage_host`` the host's ms between the
    same hooks; ``host`` the host's ms of the graph work by step
    (``_time_setup``); ``buckets`` (a list) the bucket shapes (S, E, En,
    Ex, T) in the order they flush."""
    re_ = Reestimator(models, mode=mode, batch_size=16, device=dev)
    last_t = [0.0]
    if stages is not None:
        last = [torch.cuda.Event(enable_timing=True)]
        last[0].record()
        marks = []

        def hook(stage):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((stage, last[0], ev))
            last[0] = ev
            now = time.perf_counter()
            if stage_host is not None:
                stage_host[stage] = stage_host.get(stage, 0.0) + \
                    (now - last_t[0]) * 1e3
            last_t[0] = now
        re_.stage_hook = hook
    if buckets is not None:
        flush = re_._flush_bucket

        def record(key):
            buckets.append(key)
            flush(key)
        re_._flush_bucket = record
    undo = _time_setup(re_, host) if host is not None else None
    torch.cuda.synchronize()
    t = last_t[0] = time.perf_counter()
    try:
        for x, names in utts:
            re_.add_utterance(x, names)
        acc = re_.finish()
        torch.cuda.synchronize()
    finally:
        if undo is not None:
            undo()
    wall = time.perf_counter() - t
    if stages is not None:
        for stage, a, b in marks:
            stages[stage] = stages.get(stage, 0.0) + a.elapsed_time(b)
    return acc, re_.total_log_like, wall


# the card's accumulators against the CPU port's on the same inputs: K's
# lses and the stats' GEMMs and index_add_ sum in other orders
REL_TRAIN_ACC = 1e-4
# the phoneme loop's occupancies: float32 logaddexp chains drift ~1e-5 a
# frame (phnrec_tpu's own test allows 1e-3 at 20 frames); measured 2.6e-3
# at 200 frames (CPU) and 9.8e-3 at 500 frames (the card) of the CZ
# package's log-posteriors
TOL_OCC_ROWS = 2e-2


def _acc_err(got, want) -> float:
    return max(trainfb_variants.rel_err(g.cpu(), w.cpu())
               for g, w in zip(got, want) if g is not None)


def _check_long_graphs(models, longs, shapes, dev, seed: int = 32) -> list:
    """Kernels K and K' on the design the plan gives each of ``longs``
    ((x, names) pairs) at the bucket shape its pass flushed (``shapes``:
    (S, E, En, Ex, T), one an utterance), against the plain versions on
    the card: each utterance's own graph and frame count, seeded random
    observations.  The launches count nothing.  The records of
    trainfb_variants.check_graphs, with S, T and the cluster size."""
    lib = trainfb._lib()
    rng = np.random.default_rng(seed)
    if len(shapes) != len(longs):
        raise AssertionError(f"long utterances in {len(shapes)} buckets")
    out = []
    for (x, names), key in zip(longs, shapes):
        S, T = key[0], key[-1]
        args = (*trainfb_variants.graph_batch(models, [names], S, dev),
                trainfb_variants.logpost(rng, 1, T, S, dev))
        n = torch.tensor([len(x)], dtype=torch.int32, device=dev)
        rec = trainfb_variants.check_graphs(
            lambda *a: trainfb.launch_fb(lib, *a),
            lambda *a: trainfb.launch_align(lib, *a), args, n)
        out.append(dict(S=S, T=T, n=len(x),
                        cluster=trainfb.plan(lib, False, 1, S, dev), **rec))
    return out


def train_posteriors(sr, cpu_sr, tmp: str, dev, B: int = 256,
                     seconds: float = 5.0) -> dict:
    """The posterior route: B seeded utterances of ``seconds`` through the
    CZ LCRC package's batch pipeline on the card (kernel A's
    log-posteriors, C and D's labels), netgen's PDFObsVec HMM set over the
    46 phonemes, each utterance transcribed by its own labels; two
    Baum-Welch iterations (update_ml -> apply_update), one Viterbi
    iteration, write_mmf.  The log-likelihood must not fall from
    iteration 1 to 2; on 8 utterances the card's accumulators equal the
    CPU port's within REL_TRAIN_ACC; the phoneme-loop occupancies of 16
    utterances (kernel J) sum to 1 a frame within TOL_OCC_ROWS.  Two ~25 s
    utterances (five files each) take Baum-Welch and Viterbi past the
    clusters' reach, on the one-block K and K', which are then held to
    their plain versions on those graphs at their buckets' shapes
    (``_check_long_graphs``).  Returns the launches."""
    from phnrec_tpu_torch.decoder.forward_backward import occupancies
    utts, lp, n_frames, labels = train_turns.posterior_inputs(
        sr, B, seconds)
    models = trainfb_variants.hmm_set(tmp, sr.phonemes)
    tr_counts = (*GRAPH_KERNELS, *J_KERNELS)
    reset_counts(tr_counts)
    out, lls = {}, []
    stages: dict = {}
    stage_host: dict = {}
    setup_host: dict = {}
    t_all = time.perf_counter()
    for it, mode in enumerate(("baum_welch", "baum_welch", "viterbi")):
        idx = build_model_index(models)
        acc, ll, wall = _reestimate(models, utts, mode, dev,
                                    *((stages, setup_host, stage_host)
                                      if it == 0 else ()))
        t = time.perf_counter()
        upd = update_ml(idx, acc, [models.hmms[k].log_transp
                                   for k in idx.names])
        models = apply_update(models, idx, upd)
        out[f"iter{it + 1}_{mode}"] = dict(wall_s=wall, log_like=ll,
                                           update_s=time.perf_counter() - t)
        lls.append(ll)
    # two long utterances (five files' log-posteriors and labels each, ~25
    # s): their graphs pass the clusters' reach, the one-block kernels
    longs = [(np.concatenate([u[0] for u in utts[i: i + 5]]),
              [n for u in utts[i: i + 5] for n in u[1]]) for i in (0, 5)]
    long_out = {"states": [3 * len(u[1]) for u in longs],
                "frames": [len(u[0]) for u in longs]}
    shapes: list = []
    for mode in ("baum_welch", "viterbi"):
        _, ll, wall = _reestimate(models, longs, mode, dev,
                                  buckets=shapes if mode == "viterbi"
                                  else None)
        long_out[mode] = dict(wall_s=wall, log_like=ll)
        if not np.isfinite(ll):
            raise AssertionError(f"long utterances: log-likelihood {ll}")
    long_out["checks"] = _check_long_graphs(models, longs, shapes, dev)
    mmf = os.path.join(tmp, "trained.mmf")
    write_mmf(models, mmf)
    launches = read_counts(tr_counts)
    # the card against the CPU port on 8 utterances
    base = trainfb_variants.hmm_set(tmp, sr.phonemes)
    a_card = _reestimate(base, utts[:8], "baum_welch", dev)[0]
    a_cpu = _reestimate(base, utts[:8], "baum_welch", "cpu")[0]
    err = _acc_err(a_card, a_cpu)
    # the phoneme-loop occupancies of 16 utterances (kernel J's group
    # instance), then of one seeded utterance on a loop of 400 x 3 states
    # (the block instance)
    t = time.perf_counter()
    rows = [occupancies(sr.loop_spec, lp[b, : n_frames[b]]).sum(1)
            for b in range(min(16, B))]
    occ_s = time.perf_counter() - t
    wide = sr.loop_spec._replace(n_phonemes=400)
    rows.append(occupancies(wide, trainfb_variants.logpost(
        np.random.default_rng(25), 1, 60, 1200, dev)[0]).sum(1))
    launches.update(read_counts(J_KERNELS))
    row_err = float(max(np.abs(r - 1.0).max() for r in rows))
    audio_s = B * seconds
    first = out["iter1_baum_welch"]["wall_s"]
    phase("train_posteriors", utterances=B, seconds_each=seconds,
          labels_per_utt=float(np.mean([len(u[1]) for u in utts])),
          states_per_graph=float(np.mean([3 * len(u[1]) for u in utts])),
          iterations=out, log_like_rises=lls[1] >= lls[0],
          utterances_per_s=B / first, audio_s_per_s=audio_s / first,
          stage_ms_iter1=stages, stage_host_ms_iter1=stage_host,
          bucket_setup_host_ms_iter1=setup_host,
          long_utterances=long_out,
          card_vs_cpu_rel_err=err,
          tol=REL_TRAIN_ACC, occupancy_row_err=row_err,
          occupancies_s=occ_s, launches=launches,
          total_s=time.perf_counter() - t_all, mmf_bytes=os.path.getsize(mmf))
    if not lls[1] >= lls[0]:
        raise AssertionError(f"Baum-Welch log-likelihood fell: {lls}")
    if err > REL_TRAIN_ACC:
        raise AssertionError(f"card accumulators differ from the CPU: {err}")
    if row_err > TOL_OCC_ROWS:
        raise AssertionError(f"occupancy rows off 1 by {row_err}")
    if not all(launches[k] for k in GRAPH_KERNELS):
        raise AssertionError(f"kernel K / K' not launched: {launches}")
    if not all(trainfb_variants.graphs_ok(r) for r in long_out["checks"]):
        raise AssertionError(f"K / K' differ on the long utterances' graphs: "
                             f"{long_out['checks']}")
    return dict(launches=launches, utts=utts, labels=labels)


def train_gmm(pkg: str, sr, tmp: str, dev, n: int = 64,
              n_mbr: int = 16) -> dict:
    """The GMM route: the CLI writes -t par files for n seeded CZ files,
    io/features.read_features(..., deriv_order=2) reads them back (15 log
    mel banks with deltas and accelerations, 45 dims), a seeded DiagC set
    of 46 x 3 states x 8 mixtures around the data's mean and spread; one
    Baum-Welch iteration with update_ml, then sMBR statistics with
    update_mmi on n_mbr utterances (the transcription graph as its own
    stand-in lattice, as tests/test_train_aux.py does).  The transcriptions
    are the files' own phoneme-loop labels.  Returns the launches."""
    from phnrec_tpu_torch import cli
    from phnrec_tpu_torch.io.features import read_features
    d = os.path.join(tmp, "gmm")
    os.makedirs(d)
    paths = synth.write_audio_files(d, n, (3.0, 6.0), seed=41)
    lst = os.path.join(d, "par.scp")
    with open(lst, "w") as f:
        f.write("".join(f"{p} {os.path.splitext(p)[0]}.par\n"
                        for p in paths))
    t = time.perf_counter()
    if cli.main(["-c", pkg, "-t", "par", "-l", lst, "--device",
                 str(dev)]) != 0:
        raise AssertionError("cli -t par failed")
    par_s = time.perf_counter() - t
    feats = [read_features(os.path.splitext(p)[0] + ".par",
                           deriv_order=2)[0] for p in paths]
    if feats[0].shape[1] != 45:
        raise AssertionError(f"features of {feats[0].shape[1]} dims")
    names = [[l.name for l in sr.process_offline(
        "wf", "str", open(p, "rb").read()).labels] for p in paths]
    allx = np.concatenate(feats)
    models = parse_mmf(synth.write_gmm_models(
        os.path.join(d, "gmm.mmf"), sr.phonemes, dim=45, seed=5,
        mean=allx.mean(0), std=allx.std(0)))
    utts = list(zip(feats, names))
    reset_counts(GRAPH_KERNELS)
    idx = build_model_index(models)
    stages: dict = {}
    acc, ll, wall = _reestimate(models, utts, "baum_welch", dev, stages)
    t = time.perf_counter()
    old = [models.hmms[k].log_transp for k in idx.names]
    upd = update_ml(idx, acc, old)
    new = apply_update(models, idx, upd)
    update_s = time.perf_counter() - t
    # sMBR on n_mbr utterances
    t = time.perf_counter()
    num = make_accumulators(idx, dev)
    den = make_accumulators(idx, dev)
    for x, nm in utts[:n_mbr]:
        g = compile_transcription(models, nm, idx)
        xt = torch.from_numpy(x).to(dev)
        lb, _ = log_obs(make_obs_tables(g, dev), xt)
        al = viterbi_align(g.log_A, g.log_entry, g.log_exit, lb, x.shape[0])
        ref = reference_hmm_ids(g, al.states)
        num, den = accumulate_utterance_mbr(g, num, den, xt, ref, x.shape[0])
    mmi = update_mmi(idx, num, den, old)
    torch.cuda.synchronize()
    mbr_s = time.perf_counter() - t
    launches = read_counts(GRAPH_KERNELS)
    kappa = (float(num.occ.sum()), float(den.occ.sum()))
    phase("train_gmm", files=n, par_cli_s=par_s, dims=45, mixtures=8,
          frames=int(sum(x.shape[0] for x in feats)), bw_wall_s=wall,
          bw_log_like=ll, stage_ms=stages, update_s=update_s,
          utterances_per_s=n / wall,
          audio_s_per_s=sum(x.shape[0] for x in feats) / 100.0 / wall,
          mbr_utterances=n_mbr, mbr_s=mbr_s, kappa_num_den=kappa,
          mmi_variances_positive=bool(np.all(mmi.variances > 0)),
          means_moved=not np.allclose(
              new.hmms[idx.names[0]].gmm_states[0].means,
              models.hmms[idx.names[0]].gmm_states[0].means),
          launches=launches)
    # (the sMBR masses balance only as far as each frame's occupancies sum
    # to 1: float32 alphas of ~3e4 drift them by a few percent over 600
    # frames, in phnrec_tpu's formulation as in the port's)
    if not np.isfinite(ll) or not np.all(mmi.variances > 0) or \
            not kappa[0] > 0:
        raise AssertionError("GMM route: non-finite likelihood, a variance "
                             f"<= 0 or no sMBR mass {kappa}")
    if launches["graph_fb_cluster"] == 0 or \
            launches["graph_align_cluster"] == 0:
        raise AssertionError(f"kernel K / K' not launched: {launches}")
    return launches


def device_busy_share(fn, kernels: bool = False):
    """Share of one run's wall in which some CUDA kernel or copy ran, from
    torch.profiler; None if the trace holds no device events.  With
    ``kernels``, also the device ms of the eight kernels that took the
    most, by name (the first 60 characters)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    # a host range (the program's spans) also shows on the device's
    # timeline: not work
    dev_events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA and e.time_range.end >
                  e.time_range.start and not e.is_user_annotation]
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in dev_events)
    if not spans:
        return None
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    out = dict(busy_us=busy, wall_us=wall_us, share=busy / wall_us)
    if kernels:
        by = {}
        for e in dev_events:
            k = e.name[:60]
            by[k] = by.get(k, 0.0) + (e.time_range.end
                                      - e.time_range.start) / 1e3
        out["kernel_ms"] = dict(sorted(by.items(), key=lambda kv: -kv[1])[:8])
    return out


# -- the host-side remainder: live input, the CLI's VAD / profiling /
# trace, torch.distributed, the in-flight list decode, the native library
LIVE_KERNELS = ("mlp_fused", "phnloop_viterbi", "phnloop_viterbi_ragged",
                "backtrack", "backtrack_committed")


def _live_run(sr, path: str, fmt: str, recognizer=None):
    """live.run_live over a file, its StreamingRecognizer made by
    ``recognizer`` (a capturing or replaying subclass) when given:
    (emitted lines, final labels, wall s)."""
    from phnrec_tpu_torch import live
    lines = []
    orig = live.StreamingRecognizer
    if recognizer is not None:
        live.StreamingRecognizer = recognizer
    try:
        if sr.device.type == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        labels = live.run_live(sr, out_format=fmt, source=path,
                               emit=lines.append)
        if sr.device.type == "cuda":
            torch.cuda.synchronize()
        return lines, labels, time.perf_counter() - t
    finally:
        live.StreamingRecognizer = orig


def _live_chunks(sr, raw: bytes):
    """The StreamingRecognizer run_live makes, fed run_live's 1/8 s chunks
    directly."""
    tp = sr.cfg.get_int("decoder", "time_pruning")
    rec = StreamingRecognizer(sr, commit_horizon=max(4 * tp, 512))
    chunk = sr.cfg.get_int("source", "sample_freq") // 8 * 2
    for i in range(0, len(raw), chunk):
        rec.process(raw[i: i + chunk])
    return rec.finish()


def live_phase(name: str, sr, cpu_sr, tmp: str, seconds: float = 20.0,
               seed: int = 61) -> dict:
    """run_live (the CLI's -a) over ``seconds`` of seeded audio from a
    file on the card: the emitted lines equal the final labels (in KWS
    mode: the hits at or above their keyword's threshold); the labels
    equal StreamingRecognizer fed the same 1/8 s chunks on the card, and
    the CPU port's run_live on the same bytes decoding the card's
    log-posteriors (names, boundaries, scores: as phnloop_vs_cpu holds
    serving); the CPU port's labels from its own log-posteriors are
    reported.  Returns the bytes, the lines and the launches."""
    from phnrec_tpu_torch.live import format_live
    fs = sr.cfg.get_int("source", "sample_freq")
    raw = synth.synth_audio(np.random.default_rng(seed), int(seconds * fs),
                            fs).astype("<i2").tobytes()
    path = os.path.join(tmp, f"{name}.raw")
    with open(path, "wb") as f:
        f.write(raw)
    kws = sr.stk_decoder is not None
    fmt = "lab" if kws else "str"
    caps = []

    def capture(s, **kw):
        caps.append(_SCapture(s, **kw))
        return caps[-1]
    _live_run(sr, path, fmt)            # the first run pays one-off costs
    reset_counts(LIVE_KERNELS + G_KERNELS + ("lrtrace",))
    lines, labels, wall = _live_run(sr, path, fmt, capture)
    launches = {k: v for k, v in read_counts(
        LIVE_KERNELS + G_KERNELS + ("lrtrace",)).items() if v}
    direct = _live_chunks(sr, raw)
    replay = _live_run(cpu_sr, path, fmt,
                       lambda s, **kw: _SReplay(caps[0].lps, s, **kw))
    own = _live_run(cpu_sr, path, fmt)[1]
    if kws:
        thr = sr.stk_decoder.keyword_thresholds
        want_lines = sorted(format_live(h, fmt) for h in labels
                            if not h.score < thr.get(h.name))
        lines_equal = sorted(lines) == want_lines
    else:
        lines_equal = "".join(lines).split() == [l.name for l in labels]
    n_chunks = -(-len(raw) // (fs // 8 * 2))
    rec = dict(seconds=seconds, chunks=n_chunks, wall_s=wall,
               real_time_factor=wall / seconds, chunks_per_s=n_chunks / wall,
               labels=len(labels), lines=len(lines), lines_equal=lines_equal,
               streaming_equal=full_key(direct) == full_key(labels),
               cpu_replay_equal=full_key(replay[1]) == full_key(labels),
               cpu_replay_lines_equal=replay[0] == lines,
               cpu_own_lp_labels_equal=label_key(own) == label_key(labels),
               launches=launches)
    phase(name, **rec)
    if not (labels and lines_equal and rec["streaming_equal"]
            and rec["cpu_replay_equal"] and rec["cpu_replay_lines_equal"]):
        raise AssertionError(f"{name}: {rec}")
    if not launches.get("mlp_fused") or not (
            launches.get("lrtrace") if kws else
            launches.get("phnloop_viterbi")):
        raise AssertionError(f"{name} skipped a kernel: {launches}")
    return dict(raw=raw, lines=lines, launches=launches, wall_s=wall)


def live_pipe(pkg: str, live: dict, dev) -> None:
    """python -m phnrec_tpu_torch.cli -a -c PKG -f str in a subprocess,
    the raw bytes on stdin: its stdout equals live_replay's lines."""
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "phnrec_tpu_torch.cli", "-a", "-c", pkg,
         "-f", "str", "--device", str(dev)], input=live["raw"],
        capture_output=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    out = proc.stdout.decode().splitlines()
    rec = dict(rc=proc.returncode, wall_s=time.perf_counter() - t,
               lines=len(out), equal=out == live["lines"])
    phase("live_pipe", **rec)
    if proc.returncode != 0 or not rec["equal"]:
        raise AssertionError(f"live_pipe: {rec}\n"
                             f"{proc.stderr.decode()[-2000:]}")


def cli_alize_profile(pkg: str, sr, paths, tmp: str, dev) -> None:
    """The CLI with --alize on four files (lines equal labels_to_alize of
    the same files' labels), with --profile (the five stages each called)
    and with --trace=DIR (a Chrome trace naming kernel A's or C's
    function)."""
    import contextlib
    import io

    from phnrec_tpu_torch import cli
    from phnrec_tpu_torch.vad import labels_to_alize
    lst = os.path.join(tmp, "alize.scp")
    with open(lst, "w") as f:
        f.write("".join(f"{p} {p}.vad\n" for p in paths[:4]))
    if cli.main(["--alize", "-c", pkg, "-l", lst, "--device", str(dev)]):
        raise AssertionError("--alize returned an error")
    alize = [open(p + ".vad").read().splitlines() ==
             labels_to_alize(sr.process_offline(
                 "wf", "str", open(p, "rb").read()).labels)
             for p in paths[:4]]
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["--profile", "-c", pkg, "-i", paths[0], "-o",
                       os.path.join(tmp, "p.rec"), "--device", str(dev)])
    stages = {}
    for line in err.getvalue().splitlines():
        parts = line.split()
        if len(parts) == 4 and parts[1].isdigit():
            stages[parts[0]] = dict(calls=int(parts[1]),
                                    seconds=float(parts[2]))
    five = ("wave_convert", "mel_frontend", "posteriors", "viterbi",
            "backtrack")
    trace_dir = os.path.join(tmp, "trace")
    rc_t = cli.main([f"--trace={trace_dir}", "-c", pkg, "-i", paths[0],
                     "-o", os.path.join(tmp, "t.rec"), "--device", str(dev)])
    files = os.listdir(trace_dir) if os.path.isdir(trace_dir) else []
    text = "".join(open(os.path.join(trace_dir, f)).read() for f in files)
    named = [k for k in ("mlp_fused_kernel", "viterbi_kernel",
                         "backtrack_kernel") if k in text]
    rec = dict(alize_files=len(alize), alize_equal=alize,
               profile_rc=rc, stages=stages, trace_rc=rc_t,
               trace_files=files, trace_bytes=len(text),
               trace_kernels=named)
    phase("cli_alize_profile", **rec)
    if not all(alize) or rc or rc_t or not files or not named or \
            not all(stages.get(s, {}).get("calls", 0) > 0 for s in five):
        raise AssertionError(f"cli_alize_profile: {rec}")


def list_overlap(pkg: str, tmp: str, cli_wall: float, dev) -> dict:
    """The CLI list decode of run_cli's 64 CZ files again, with up to three
    batches in flight (the default), then with each batch's segments
    waited for before the next batch (the serial order), then in flight
    again: every MLF equals the cli phase's.  Returns the launches of the
    first run."""
    from phnrec_tpu_torch import cli
    lst = os.path.join(tmp, "list.scp")
    want = open(os.path.join(tmp, "out.mlf")).read()
    start = phnloop.fetch_segments_start

    def serial(segs, cap=128):
        pending = start(segs, cap)
        if pending[2] is not None:
            pending[2].synchronize()
        return pending
    walls, equal, launches = {}, {}, None
    for name in ("in_flight", "serial", "in_flight_again"):
        mlf = os.path.join(tmp, f"overlap_{name}.mlf")
        if name == "serial":
            phnloop.fetch_segments_start = serial
        reset_counts(BATCH_KERNELS)
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            rc = cli.main(["-c", pkg, "-l", lst, "-m", mlf, "--device",
                           str(dev)])
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t
        finally:
            phnloop.fetch_segments_start = start
        launches = launches or read_counts(BATCH_KERNELS)
        equal[name] = rc == 0 and open(mlf).read() == want
    phase("list_overlap", files=len(open(lst).read().split()), wall_s=walls, cli_wall_s=cli_wall,
          mlf_equal=equal, launches=launches)
    if not all(equal.values()) or not all(launches.values()):
        raise AssertionError(f"list_overlap: {equal} {launches}")
    return launches


def check_native(dev) -> None:
    """The native host library is built here, and backtrack_batch's native
    route on the card's History (kernel C's, at the backtrack phase's
    shapes) equals the Python replay and kernel D's walk."""
    from phnrec_tpu_torch import native
    if not native.available():
        raise AssertionError("the native host library did not build")
    P, S, B, T = 46, 3, 256, 500
    rng = np.random.default_rng(4)
    spec = phnloop.PhnLoopSpec(n_phonemes=P, n_states=S, w_penalty=-4.6875)
    lp = torch.from_numpy(np.log(rng.dirichlet(np.ones(P * S), size=(B, T)))
                          .astype(np.float32)).to(dev)
    hist = phnloop.viterbi_scan_batch(spec, lp)
    n_frames = rng.integers(S, T + 1, size=B).astype(np.int32)
    names = [f"p{i}" for i in range(P)]
    t = time.perf_counter()
    got = phnloop.backtrack_batch(hist, n_frames, names)
    native_ms = (time.perf_counter() - t) * 1e3
    avail = native.available
    native.available = lambda: False
    try:
        t = time.perf_counter()
        want = phnloop.backtrack_batch(hist, n_frames, names)
        python_ms = (time.perf_counter() - t) * 1e3
    finally:
        native.available = avail
    dev_labels = phnloop.labels_from_segments(phnloop.fetch_segments(
        phnloop.backtrack_device(spec, hist, torch.from_numpy(n_frames))),
        n_frames, names)
    rec = dict(available=True, library=str(native.lib_path()), B=B, T=T,
               native_ms=native_ms, python_ms=python_ms,
               labels=sum(map(len, got)),
               python_equal=[full_key(a) for a in got] ==
               [full_key(b) for b in want],
               kernel_d_equal=[full_key(a) for a in got] ==
               [full_key(b) for b in dev_labels])
    phase("native", **rec)
    if not rec["python_equal"] or not rec["kernel_d_equal"]:
        raise AssertionError(f"native: {rec}")


def _server_runs(ssr, en_sr, sd_sr, mesh, dev, n: int = 4,
                 seconds: float = 10.0):
    """The three servers on 4 streams x 10 s: the phoneme loop and KWS fed
    2 s chunks through process() (the phoneme loop with commit_horizon
    256), stkint decode from a card buffer through
    decode_device_buffer(shard_audio(...)) with record_horizon 256."""
    out = {}
    for name, sr, cls, kw in (
            ("phnloop", ssr, MultiStreamRecognizer,
             dict(commit_horizon=256)),
            ("kws", en_sr, MultiStreamKWS, {})):
        fs = sr.cfg.get_int("source", "sample_freq")
        rng = np.random.default_rng(71)
        streams = [synth.synth_audio(rng, int((seconds - i) * fs), fs)
                   .astype("<i2").tobytes() for i in range(n)]
        out[name] = _feed_chunks(cls(sr, n, block_frames=512, mesh=mesh,
                                     **kw), streams)
    rng = np.random.default_rng(72)
    audio = np.stack([synth.synth_audio(rng, int(seconds * 8000))
                      .astype(np.int16) for _ in range(n)])
    ms = MultiStreamStkDecode(sd_sr, n, block_frames=512, mesh=mesh,
                              record_horizon=256)
    buf = ms.shard_audio(audio) if mesh is not None else \
        torch.from_numpy(audio).to(dev)
    ms.decode_device_buffer(buf, n_blocks=(len(audio[0]) - 400) // 40960)
    out["stk"] = ms.finish()
    return out


def distributed_phase(sr, ssr, en_sr, sd_sr, tmp: str, paths, dev) -> dict:
    """torch.distributed on the card at world size 1 (the machine holds
    one card): an NCCL group over a FileStore, a DeviceMesh with a "data"
    dimension.  DistributedRunner over run_cli's 64 files with an MLF
    (labels equal the cli phase's process_file_list MLF, scores within
    1e-3), again with its progress file (0 utterances);
    aggregate_metrics over the mesh equals the local counters;
    BatchPipeline(mesh=) and the three servers with mesh= equal their
    unsharded runs; psum_accumulators of one bucket's accumulators equals
    them.  Returns the runner's launches."""
    from datetime import timedelta

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from phnrec_tpu_torch.parallel.batch import (BatchPipeline,
                                                 aggregate_metrics)
    from phnrec_tpu_torch.parallel.distributed import (DistributedRunner,
                                                       RunMetrics)
    from phnrec_tpu_torch.train import psum_accumulators
    if dev.type == "cuda":
        torch.cuda.set_device(dev)      # NCCL's device, before any collective
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        store=dist.FileStore(os.path.join(tmp, "dist_store"), 1),
        rank=0, world_size=1, timeout=timedelta(seconds=120))
    try:
        mesh = init_device_mesh(dev.type, (1,), mesh_dim_names=("data",))
        lst = os.path.join(tmp, "list.scp")
        prog = os.path.join(tmp, "progress.jsonl")
        reset_counts(BATCH_KERNELS)
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = DistributedRunner(sr, progress_file=prog).run(
            lst, mlf_path=os.path.join(tmp, "runner.mlf"))
        wall = time.perf_counter() - t
        launches = read_counts(BATCH_KERNELS)
        got = read_mlf(os.path.join(tmp, "runner.mlf"))
        want = read_mlf(os.path.join(tmp, "out.mlf"))
        keys_equal = list(got) == list(want) and all(
            label_key(got[k]) == label_key(want[k]) for k in want)
        score_err = max((abs(a.score - b.score) for k in want
                         for a, b in zip(got.get(k, []), want[k])),
                        default=0.0)
        text_equal = open(os.path.join(tmp, "runner.mlf")).read() == \
            open(os.path.join(tmp, "out.mlf")).read()
        resumed = DistributedRunner(sr, progress_file=prog).run(lst)
        local = {k: metrics[k] for k in ("audio_seconds", "n_frames",
                                         "n_utterances", "n_labels")}
        agg_equal = aggregate_metrics(local, mesh) == local

        rng = np.random.default_rng(81)
        ns = rng.integers(8000, 40000, 16).astype(np.int32)
        wave = np.zeros((16, int(ns.max())), np.int16)
        for i, k in enumerate(ns):
            wave[i, :k] = synth.synth_audio(rng, int(k))
        batch_equal = BatchPipeline(sr, mesh=mesh).run_padded(
            wave, ns).labels == BatchPipeline(sr).run_padded(wave, ns).labels

        reset_counts(KERNELS)
        sharded = _server_runs(ssr, en_sr, sd_sr, mesh, dev)
        server_launches = {k: v for k, v in read_counts(KERNELS).items()
                           if v}
        whole = _server_runs(ssr, en_sr, sd_sr, None, dev)
        servers_equal = {k: [full_key(a) for a in sharded[k]] ==
                         [full_key(b) for b in whole[k]] and any(whole[k])
                         for k in whole}

        models = trainfb_variants.hmm_set(tmp, sr.phonemes)
        g = compile_transcription(models, sr.phonemes[:6])
        acc = make_accumulators(g.index, dev)
        x = np.log(rng.dirichlet(np.ones(len(sr.phonemes) * 3), size=300)
                   ).astype(np.float32)
        from phnrec_tpu_torch.train import accumulate_utterance
        acc = accumulate_utterance(g, acc, x, 300)
        summed = psum_accumulators(acc, mesh)
        psum_equal = all((a is None and b is None) or torch.equal(a, b)
                         for a, b in zip(summed, acc))
        rec = dict(world_size=dist.get_world_size(), backend=dist.get_backend(),
                   runner=dict(files=len(paths), wall_s=wall,
                               n_utterances=metrics["n_utterances"],
                               audio_sec_per_s=metrics["audio_sec_per_s"],
                               launches=launches, labels_equal=keys_equal,
                               max_score_err=score_err,
                               mlf_text_equal=text_equal),
                   resumed_utterances=resumed["n_utterances"],
                   aggregate_equal=agg_equal, batch_mesh_equal=batch_equal,
                   servers_mesh_equal=servers_equal,
                   server_launches=server_launches, psum_equal=psum_equal)
    finally:
        dist.destroy_process_group()
    phase("distributed", **rec)
    if not (keys_equal and score_err <= 1e-3 and metrics["n_utterances"] ==
            len(paths) and resumed["n_utterances"] == 0 and agg_equal and
            batch_equal and all(servers_equal.values()) and psum_equal and
            all(launches.values())):
        raise AssertionError(f"distributed: {rec}")
    return launches


# -- the last public surface: single-utterance posteriors and the twins of
# examples/
SINGLE_KERNELS = ("mlp_fused", "mlp_bf16x3", *WIDE_KERNELS)
# (launches, of them with the band index, of them on the split path) of
# one single-utterance call: LCRC's two band nets and merger; 3BT's and
# 1BT's band stack and merger (past n_inp 480); 1BT_DCT's merger
SINGLE_LAUNCHES = {"LCRC": (3, 0, 0), "3BT": (2, 1, 1), "1BT": (2, 1, 1),
                   "1BT_DCT": (1, 0, 0)}


def posteriors_single(srs: dict, dev) -> dict:
    """``posteriors`` of one 5 s utterance of each system at full width
    (the CZ LCRC package; 3BT, 1BT and 1BT_DCT at the CZ widths), at
    "highest" (kernel A) and "high" (A′), held within TOL_SOFTMAX to the
    plain version of ``posteriors_batched`` on that utterance alone, and
    compared with its row of ``posteriors_batched`` over 4 utterances of
    that length.  Kernel A sums a row alike at any row count, so at
    "highest" that row must be bit-equal; A′ picks its tile, and with it
    the second product's slab depth, by the call's rows (all bands
    together), so at "high" the row's bit-equality and distance are
    reported.  A's or A′'s launches, band-index launches and split-path
    launches are counted around the single call; its ms and the batch's
    by cuda_ms.  Returns the launches."""
    from phnrec_tpu_torch import normalization
    rng = np.random.default_rng(91)
    total = dict.fromkeys(SINGLE_KERNELS, 0)
    recs = {}
    ok = True
    for system, sr in srs.items():
        raws = [synth.synth_audio(rng, 5 * 8000).astype("<i2").tobytes()
                for _ in range(4)]
        par = np.stack([sr.params_from_waveform(r) for r in raws])
        par = torch.from_numpy(par[..., : sr.frontend.n_params]).to(dev)
        n = torch.full((4,), par.shape[1], dtype=torch.int32, device=dev)
        x = normalization.sentence_norm(par, sr.sent_norm, n_valid=n)
        est = sr.estimator
        for mode in ("highest", "high"):
            precision.set_mode(mode)
            kern = "mlp_fused" if mode == "highest" else "mlp_bf16x3"
            mod = mlp_fused if mode == "highest" else mlp_bf16x3
            with torch.inference_mode():
                reset_counts(SINGLE_KERNELS)
                bands = mod.BAND_LAUNCHES
                one = est.posteriors(x[0])
                torch.cuda.synchronize()
                counts = read_counts(SINGLE_KERNELS)
                bands = mod.BAND_LAUNCHES - bands
                plain_err = float((one - est.posteriors_batched(
                    x[:1], n[:1], plain=True)[0]).abs().max())
                rows = est.posteriors_batched(x, n)
                equal = torch.equal(one, rows[0])
                err = float((one - rows[0]).abs().max())
                ms = cuda_ms(lambda: est.posteriors(x[0]))
                batch_ms = cuda_ms(lambda: est.posteriors_batched(x, n))
            for k, v in counts.items():
                total[k] += v
            got = (counts[kern], bands, counts[kern + "_wide"])
            recs[f"{system}_{mode}"] = dict(
                frames=par.shape[1], n_out=one.shape[1],
                max_err_plain=plain_err, bit_equal_in_batch=equal,
                max_err_in_batch=err,
                finite=bool(torch.isfinite(one).all()), launches=counts,
                band_launches=bands, ms=ms, batch_of_4_ms=batch_ms)
            others = sum(v for k, v in counts.items()
                         if k not in (kern, kern + "_wide"))
            ok &= (plain_err <= TOL_SOFTMAX
                   and (equal or mode == "high")
                   and recs[f"{system}_{mode}"]["finite"]
                   and got == SINGLE_LAUNCHES[system] and not others)
    precision.set_mode("highest")
    phase("posteriors_single", expected=SINGLE_LAUNCHES,
          tol_plain=TOL_SOFTMAX, **recs)
    if not ok:
        raise AssertionError(f"posteriors_single: {recs}")
    return total


def _run_example(module, args) -> tuple:
    """A twin's main on the card, its stdout captured, every count set to
    0 just before and read just after: (lines, wall s, launches)."""
    import contextlib
    import io
    buf = io.StringIO()
    reset_counts(KERNELS)
    torch.cuda.synchronize()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = module.main(["--device", "cuda", *args])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    if rc != 0:
        raise AssertionError(f"{module.__name__} exited {rc}")
    return (buf.getvalue().splitlines(), wall,
            {k: v for k, v in read_counts(KERNELS).items() if v})


def _served_lines(ms, paths) -> list:
    """multistream_serving's lines from a server made here, fed as the
    twin feeds it (64 KiB chunks, interleaved)."""
    from phnrec_tpu_torch.io.labels import format_rec_line
    lines = []
    for path, labels in zip(paths, _feed_chunks(
            ms, [open(p, "rb").read() for p in paths], chunk=65536)):
        lines += [f"# {path}"] + [format_rec_line(l) for l in labels]
    return lines


def examples_phase(pkg: str, spkg: str, en: str, srs: dict, tmp: str,
                   dev) -> dict:
    """The five twins of examples/ through their main on the card, each
    held to the path it wraps run here: batch_decode on 16 x 5 s CZ files
    (the .rec files equal BatchPipeline.run's labels), streaming_decode on
    one 20 s CZ file at 250 ms (the lines equal StreamingRecognizer's fed
    the same chunks), keyword_spotting on the EN KWS package with two
    keywords of its phonemes (the hits equal the CPU port's
    StkNetworkDecoder.decode on the card's log-posteriors),
    multistream_serving on 4 CZ and 4 EN KWS files, and again with --mesh
    at world size 1 (the lines equal the servers' own fed the same
    chunks), train_gmm_hmm for 5 iterations (the log-likelihoods never
    fall).  Each twin's wall and launches are reported; returns the
    launches."""
    from phnrec_tpu_torch.decoder.stknet import StkNetworkDecoder
    from phnrec_tpu_torch.examples import (batch_decode, keyword_spotting,
                                           multistream_serving,
                                           streaming_decode, train_gmm_hmm)
    from phnrec_tpu_torch.io import audio
    from phnrec_tpu_torch.io.labels import format_rec_line
    from phnrec_tpu_torch.parallel.batch import BatchPipeline
    total, recs, ok = {}, {}, True

    def account(name, wall, launches, need, **checks):
        nonlocal ok
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        recs[name] = dict(wall_s=wall, launches=launches, **checks)
        ok &= all(checks.values()) and all(launches.get(k) for k in need)

    rng = np.random.default_rng(95)
    d = os.path.join(tmp, "examples")
    os.makedirs(d)
    cz = [os.path.join(d, f"cz{i:02d}.raw") for i in range(16)]
    for p in cz:
        synth.synth_audio(rng, 5 * 8000).astype("<i2").tofile(p)
    out_dir = os.path.join(d, "rec")
    lines, wall, launches = _run_example(batch_decode, [pkg, out_dir, *cz])
    sr = srs["cz"]
    want = BatchPipeline(sr).run([audio.convert_waveform(
        audio.load_waveform_bytes(p), sr.wave_format)[0] for p in cz]).labels
    files_equal = all(
        open(os.path.join(out_dir, os.path.basename(p)[:-4] + ".rec"))
        .read() == "".join(format_rec_line(l) + "\n" for l in labels)
        for p, labels in zip(cz, want))
    account("batch_decode", wall, launches, BATCH_KERNELS,
            rec_files_equal=files_equal, lines=len(lines) == len(cz))

    long = os.path.join(d, "cz20.raw")
    synth.synth_audio(rng, 20 * 8000).astype("<i2").tofile(long)
    lines, wall, launches = _run_example(streaming_decode,
                                         [spkg, long, "250"])
    rec, want, emitted = StreamingRecognizer(srs["cz_serving"]), [], 0
    raw, chunk = open(long, "rb").read(), 8000 * 250 // 1000 * 2
    for i in range(0, len(raw), chunk):
        rec.process(raw[i: i + chunk])
        settled = rec.results(settled_only=True)
        want += [f"  [settled] {l.name:6s} "
                 f"{l.start_frames * 10:6d}..{l.end_frames * 10}ms"
                 for l in settled[emitted:]]
        emitted = len(settled)
    want.append(f"final: {' '.join(l.name for l in rec.finish())}")
    account("streaming_decode", wall, launches,
            ("mlp_fused", "phnloop_viterbi"),
            lines_equal=lines == want, settled=emitted > 0)

    kw_audio = os.path.join(d, "en10.raw")
    synth.synth_audio(rng, 10 * 16000, 16000).astype("<i2").tofile(kw_audio)
    seen = {}

    class Recording(StkNetworkDecoder):
        def decode(self, log_post):
            seen["dec"], seen["lp"] = self, log_post
            return super().decode(log_post)

    keyword_spotting.StkNetworkDecoder = Recording
    try:
        lines, wall, launches = _run_example(keyword_spotting, [
            en, kw_audio, *(f"{w}={p}" for w, p in
                            synth.KEYWORDS["en"].items())])
    finally:
        keyword_spotting.StkNetworkDecoder = StkNetworkDecoder
    dec = seen["dec"]
    cpu = StkNetworkDecoder(dec.model_set, dec.network, dec.wpenalty, 1.0,
                            mode="kws", device="cpu")
    hits = cpu.decode(np.asarray(seen["lp"], np.float32))
    want = [f"{h.name:12s} {h.start_frames * 10:6d}.."
            f"{h.end_frames * 10}ms  LR={h.score:.2f}" for h in hits]
    account("keyword_spotting", wall, launches,
            (g_counter(dec.decoder),), hits=bool(hits),
            hits_equal_cpu_port=lines == want)

    en_files = [os.path.join(d, f"en{i}.raw") for i in range(4)]
    for i, p in enumerate(en_files):
        synth.synth_audio(rng, (10 - i) * 16000, 16000).astype(
            "<i2").tofile(p)
    for name, spec, files, cls, need in (
            ("multistream_cz", spkg, cz[:4], MultiStreamRecognizer,
             ("mlp_fused", "phnloop_viterbi_ragged", "backtrack")),
            ("multistream_kws", en, en_files, MultiStreamKWS,
             ("mlp_fused", "lrtrace"))):
        lines, wall, launches = _run_example(multistream_serving,
                                             [spec, *files])
        served = _served_lines(cls(srs[name], n_streams=len(files)), files)
        meshed, mesh_wall, mesh_launches = _run_example(
            multistream_serving, ["--mesh", spec, *files])
        account(name, wall, launches, need, lines_equal_server=lines ==
                served, labels=len(lines) > len(files),
                mesh_equal=meshed == [f"# sharding {len(files)} streams "
                                      "over 1 devices"] + lines)
        account(name + "_mesh", mesh_wall, mesh_launches, need)

    cwd = os.getcwd()
    os.chdir(d)
    try:
        lines, wall, launches = _run_example(train_gmm_hmm, ["5"])
    finally:
        os.chdir(cwd)
    ll = [float(l.split()[4]) for l in lines if l.startswith("iter ")]
    account("train_gmm_hmm", wall, launches, (), iterations=len(ll) == 5,
            never_falls=all(b >= a for a, b in zip(ll, ll[1:])),
            wrote=os.path.isfile(os.path.join(d, "trained.mmf")),
            graph_kernels=any(launches.get(k) for k in GRAPH_KERNELS))
    recs["train_gmm_hmm"]["log_likes"] = ll
    phase("examples", wall_s=sum(r["wall_s"] for r in recs.values()),
          **recs)
    if not ok:
        raise AssertionError(f"examples: {recs}")
    return total


def main() -> int:
    if not torch.cuda.is_available():
        print("ERROR: no CUDA device; chip_smoke.py needs one card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = smi_line()
    phase("toolchain", nvidia_smi=smi, torch=torch.__version__,
          cuda=torch.version.cuda, nvcc=_build.find_nvcc(),
          device=torch.cuda.get_device_name(0))

    build_all()
    precision.set_mode("highest")

    with tempfile.TemporaryDirectory() as tmp:
        pkg = synth.write_lcrc_package(os.path.join(tmp, "cz"), "cz", seed=0)
        sr = SpeechRec(pkg, device=dev)
        cpu_sr = SpeechRec(pkg, device="cpu")
        results = {"mlp_fused": check_mlp(sr, dev)}
        check_mlp_odd_shapes(dev)
        results.update(check_mlp_wide(dev))
        a_ms = results["mlp_fused"].pop("per_net")
        results["mlp_bf16x3"] = check_mlp_bf16x3(sr, dev, a_ms)
        results["phnloop_viterbi"], results["backtrack"] = \
            check_viterbi_backtrack(dev)
        results["phnloop_viterbi_ragged"], \
            results["backtrack_committed"] = check_ragged_committed(dev)
        check_viterbi_cases(dev)
        check_walk_cases(dev)
        launches, cli_wall = run_cli(pkg, tmp, cpu_sr, dev)
        paths = open(os.path.join(tmp, "list.scp")).read().split()
        list_overlap(pkg, tmp, cli_wall, dev)
        cli_alize_profile(pkg, sr, paths, tmp, dev)
        check_native(dev)
        labels_highest = timed_batch(sr, dev)
        precision.set_mode("high")
        timed_batch(sr, dev, reference=labels_highest)
        precision.set_mode("highest")

        # serving applies no sentence norm (it needs the whole utterance),
        # so it runs the CZ shapes with the input norms measured without
        spkg = synth.write_lcrc_package(os.path.join(tmp, "cz_serving"),
                                        "cz", seed=0, sent_norm=False)
        ssr = SpeechRec(spkg, device=dev)
        scpu = SpeechRec(spkg, device="cpu")
        phnloop_vs_cpu(ssr, scpu, dev)
        live_pipe(spkg, live_phase("live_replay", ssr, scpu, tmp), dev)
        serve, full, walk = phnloop_serving(ssr, dev, time_walk=True)
        results["backtrack"]["serving"] = walk
        launches["phnloop_viterbi_ragged"] = serve["phnloop_viterbi_ragged"]
        precision.set_mode("high")
        launches["mlp_bf16x3"] = phnloop_serving(ssr, dev)[0]["mlp_bf16x3"]
        precision.set_mode("highest")
        launches["backtrack_committed"] = phnloop_commit(
            ssr, scpu, dev, full)["backtrack_committed"]

        en = synth.write_kws_package(os.path.join(tmp, "en"), "en", seed=0)
        en_sr = SpeechRec(en, device=dev)
        en_cpu = SpeechRec(en, device="cpu")
        check_mlp(en_sr, dev, shapes="en")
        dense = DenseKWSScan(en_sr.stk_decoder.decoder)
        b_out = check_netstep(dense, dev)
        results["netstep"] = {k: v for k, v in b_out[float(OFF_BEAM)]
                              .items() if k not in ("sinks", "n_valid",
                                                    "n_dec")}
        results["lrtrace"] = check_lrtrace(en_sr.stk_decoder.compiled,
                                           b_out[float(OFF_BEAM)], dev)
        kws_vs_cpu(en_sr, en_cpu, dev)
        live_phase("live_kws", en_sr, en_cpu, tmp, seed=62)
        launches.update(
            {k: v for k, v in kws_serving(en_sr, dev).items()
             if k in ("netstep", "lrtrace")})

        # offline STK-network decoding: the CZ stkint phoneme loop (decode
        # mode) and the EN KWS package's files (KWS mode)
        stk_pkg = synth.write_stk_decode_package(
            os.path.join(tmp, "cz_stk"), "cz", seed=0)
        stk_sr = SpeechRec(stk_pkg, device=dev)
        stk_cpu = SpeechRec(stk_pkg, device="cpu")
        check_netscan_cases({
            "cz_loop": stk_sr.stk_decoder.decoder,
            "en_kws": en_sr.stk_decoder.decoder,
            "repeated_rows": NetworkDecoder(synth.repeated_rows_network()),
            "random_big": NetworkDecoder(synth.random_network(1500, seed=1))},
            dev)
        clk = time_netscan(stk_sr.stk_decoder.decoder, dev)
        results.update(clk)
        launches.update({k: v for k, v in stk_cli(
            stk_pkg, tmp, stk_cpu, dev).items() if k in clk})
        stk_batch(stk_sr, dev, clk)
        stk_kws_files(en_sr, en_cpu, tmp, dev)

        # stkint decode serving (kernel E, H's int16 instance) on the CZ
        # loop without sentence norm; KWS serving with a global
        # <InputXform> (B) and with 300 keywords (G, then F)
        results["netdecode"], results["nettrace"]["int16"] = \
            check_netdecode({
                "cz": DenseKWSScan(stk_sr.stk_decoder.decoder), "en": dense,
                "wide_smem": synth.dense_kws_net(96, 2, 2, seed=1),
                "wide_global": synth.dense_kws_net(340, 3, 5, seed=2)},
                stk_sr.stk_decoder.decoder, dev)
        sd_pkg = synth.write_stk_decode_package(
            os.path.join(tmp, "cz_stk_serving"), "cz", seed=0,
            sent_norm=False)
        sd_sr = SpeechRec(sd_pkg, device=dev)
        sd_cpu = SpeechRec(sd_pkg, device="cpu")
        stk_serving_vs_cpu(sd_sr, sd_cpu, dev)
        distributed_phase(sr, ssr, en_sr, sd_sr, tmp, paths, dev)
        serve, results["nettrace"]["int16"]["serving_walks"] = \
            stk_serving(sd_sr, dev)
        launches["netdecode"] = serve["netdecode"]
        for name, path, kw in (
                ("kws_xform_vs_cpu", "kernel_b", dict(input_xform=True)),
                ("kws_big_vs_cpu", "kernel_g", dict(n_keywords=300))):
            kpkg = synth.write_kws_package(os.path.join(tmp, name), "en",
                                           seed=0, **kw)
            got = kws_vs_cpu(SpeechRec(kpkg, device=dev),
                             SpeechRec(kpkg, device="cpu"), dev, path, name,
                             seed=33)
        # the 1,525-model net: kernel G's block instance, by the plan
        launches["netscan"] = got.get("netscan", 0)

        # single-stream stkint streaming: decode on the CZ loop (G, the
        # host's commits), live KWS on the EN package (G, then F at each
        # pair of LRTrace's settings)
        stk_streaming_vs_cpu(sd_sr, sd_cpu, dev)
        stk_live_kws_vs_cpu(en_sr, en_cpu, dev)
        results["lrtrace"]["settings_held_ms"] = check_lrtrace_settings(dev)

        # the other posterior systems at the CZ widths, and PLP (order 12
        # into the LCRC estimator): the band stack on the band-indexed A /
        # A′, the CLI against the CPU port, a timed batch each
        tpkgs = {name: synth.write_traps_package(
            os.path.join(tmp, name), name, "cz", seed=0)
            for name in ("3BT", "1BT", "1BT_DCT")}
        tpkgs["PLP"] = synth.write_lcrc_package(os.path.join(tmp, "plp"),
                                                "cz", seed=0, plp=True)
        tsrs = {k: SpeechRec(v, device=dev) for k, v in tpkgs.items()}
        for k, v in check_bands(tsrs["3BT"], dev).items():
            results[k]["bands"] = v
        launches.update(dict.fromkeys(WIDE_KERNELS, 0))
        for name, tpkg in tpkgs.items():
            traps_cli(tpkg, name, tmp, dev)
            launches["mlp_fused_wide"] += merger_batch(tsrs[name], name,
                                                       dev)
        # the 3BT and 1BT batches at "high": the band stacks and the
        # mergers on kernel A′
        precision.set_mode("high")
        before = mlp_bf16x3.BAND_LAUNCHES
        for name in ("3BT", "1BT"):
            launches["mlp_bf16x3_wide"] += merger_batch(tsrs[name], name,
                                                        dev)
        n_high = mlp_bf16x3.BAND_LAUNCHES - before
        phase("band_launches_high", mlp_bf16x3=n_high)
        if not n_high:
            raise AssertionError("kernel A′'s band stack was not launched")
        precision.set_mode("highest")

        # HMM re-estimation: kernels J, K and K' against their plain
        # versions, the staged CLI, and the trainer's two routes
        results.update(check_trainfb_cases(dev, trainfb_variants.hmm_set(tmp, sr.phonemes)))
        staged_cli(pkg, tmp, cpu_sr, dev)
        launches.update(train_posteriors(sr, cpu_sr, tmp, dev)["launches"])
        train_gmm(pkg, sr, tmp, dev)

        # the last public surface: single-utterance posteriors of the four
        # systems, then the five twins of examples/
        t_surface = time.perf_counter()
        single = posteriors_single(
            {"LCRC": sr, **{k: tsrs[k] for k in ("3BT", "1BT", "1BT_DCT")}},
            dev)
        twins = examples_phase(pkg, spkg, en, {
            "cz": sr, "cz_serving": ssr, "multistream_cz": ssr,
            "multistream_kws": en_sr}, tmp, dev)
        for k, v in (*single.items(), *twins.items()):
            launches[k] = launches.get(k, 0) + v
        phase("surface_total", seconds=time.perf_counter() - t_surface)

    if not all(launches[k] > 0 for k in KERNELS):
        raise AssertionError(f"a kernel was not launched: {launches}")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": k["source"],
         "replaces": k["replaces"], "launches": launches[name],
         **results[name]} for name, k in KERNELS.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
