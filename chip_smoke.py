#!/usr/bin/env python3
"""Smoke test of phnrec_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the five CUDA kernels from phnrec_tpu_torch/csrc (one nvcc each, all
started together) and holds each against its plain PyTorch version on the
card at its path's shapes.  Then it drives two paths of the port:

* the batch wav->rec path, once through the CLI on a synthetic package at
  the CZ SpeechDat LCRC shapes (64 files), and times a batch of 1024 x 5 s;
* multi-stream keyword spotting (MultiStreamKWS) on a synthetic package at
  the EN TIMIT LCRC N500 shapes with the keywords greasy/wash: 4 streams x
  10 s fed through process() and held against the CPU port, then 256
  streams x 60 s staged on the card, decoded through decode_device_buffer
  in blocks of 512 frames and timed.

It prints one JSON line of kernel results, the card's name and power limit,
and a last line {"ok": true, "device": {...}}.  Any failed phase raises and
the script exits non-zero; without a CUDA card it exits non-zero before any
result.  Imports neither JAX nor phnrec_tpu.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from phnrec_tpu_torch import synth
from phnrec_tpu_torch.decoder import phnloop
from phnrec_tpu_torch.decoder.stknet import NEG, OFF_BEAM, DenseKWSScan
from phnrec_tpu_torch.io.labels import read_mlf
from phnrec_tpu_torch.multistream import MultiStreamKWS
from phnrec_tpu_torch.ops import (_build, backtrack, lrtrace, mlp_fused,
                                  netstep, phnloop_viterbi)
from phnrec_tpu_torch.pipeline import SpeechRec

KERNELS = {
    "mlp_fused": dict(module=mlp_fused, source="phnrec_tpu_torch/csrc/mlp_fused.cu",
                      replaces="phnrec_tpu/ops/pallas_mlp.py:175"),
    "phnloop_viterbi": dict(module=phnloop_viterbi,
                            source="phnrec_tpu_torch/csrc/phnloop_viterbi.cu",
                            replaces="phnrec_tpu/decoder/phnloop.py:79"),
    "backtrack": dict(module=backtrack, source="phnrec_tpu_torch/csrc/backtrack.cu",
                      replaces="phnrec_tpu/decoder/phnloop.py:375"),
    "netstep": dict(module=netstep, source="phnrec_tpu_torch/csrc/netstep.cu",
                    replaces="phnrec_tpu/ops/pallas_netstep.py:231"),
    "lrtrace": dict(module=lrtrace, source="phnrec_tpu_torch/csrc/lrtrace.cu",
                    replaces="phnrec_tpu/decoder/stknet.py:1114"),
}
BATCH_KERNELS = ("mlp_fused", "phnloop_viterbi", "backtrack")
KWS_KERNELS = ("mlp_fused", "netstep", "lrtrace")
# kernel A against cuBLAS float32: both sum in another order, and fexp is a
# step function of its argument (steps of 2^-20 relative), so outputs differ
# by a few ulp of the sums; probabilities within 2e-5, raw logits within 1e-4
TOL_SOFTMAX = 2e-5
TOL_LOGITS = 1e-4
# KWS log-posteriors, CPU port against the card: the frontend GEMMs and
# kernel A sum in another order than the CPU's, and ln amplifies the
# relative error of small posteriors
TOL_KWS_LP = 1e-3


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_mlp(sr, dev, shapes: str = "cz") -> dict:
    """Kernel A against its plain version at a package's three nets."""
    rng = np.random.default_rng(3)
    n = 65536
    nets = {"band0": sr.estimator.band[0], "band1": sr.estimator.band[1],
            "merger": sr.estimator.merger}
    worst, ms, plain_ms = 0.0, 0.0, 0.0
    for name, net in nets.items():
        z = torch.from_numpy(rng.standard_normal((n, net.n_inp), np.float32))
        x = (z.to(dev) / net.dev + net.mean).contiguous()
        args = (x, net.mean, net.dev, net.w1, net.b1, net.w2, net.b2)
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
                  softmax=smx, max_abs_err=err, tol=tol, ms=t_k, plain_ms=t_p)
            if not err <= tol:
                raise AssertionError(f"mlp_fused {name} fast={fast} "
                                     f"softmax={smx}: err {err} > {tol}")
            worst = max(worst, err)
            if fast and smx:       # the main path's setting
                ms += t_k
                plain_ms += t_p
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms)


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
    phase("phnloop_viterbi", P=P, S=S, B=B, T=T, bit_equal=True, ms=t_k,
          plain_ms=t_p)
    vit = dict(max_abs_err=0.0, ms=t_k, plain_ms=t_p)

    n_frames = torch.from_numpy(rng.integers(S, T + 1, size=B)
                                .astype(np.int32)).to(dev)
    smax = phnloop.max_segments(spec, T)
    sk = backtrack.backtrack(*hk, n_frames, smax)
    sp = backtrack.backtrack_plain(*hk, n_frames, smax)
    torch.cuda.synchronize()
    for a, b, what in zip(sk, sp, ("count", "phn", "start", "alpha_end")):
        if not torch.equal(a, b):
            raise AssertionError(f"backtrack: {what} differs")
    t_k = cuda_ms(lambda: backtrack.backtrack(*hk, n_frames, smax))
    t_p = cuda_ms(lambda: backtrack.backtrack_plain(*hk, n_frames, smax),
                  iters=3, warmup=1)
    phase("backtrack", T=T, B=B, smax=smax, equal=True,
          mean_segments=float(sk[0].float().mean()), ms=t_k, plain_ms=t_p)
    return vit, dict(max_abs_err=0.0, ms=t_k, plain_ms=t_p)


def label_key(labels):
    return [(l.start_frames, l.end_frames, l.name) for l in labels]


def run_cli(pkg: str, tmp: str, cpu_sr, dev) -> dict:
    """64 seeded int16 files of 1-8 s through the CLI, the user's entry
    point; returns each kernel's launch count over the run."""
    from phnrec_tpu_torch import cli
    wav_dir = os.path.join(tmp, "wav")
    os.makedirs(wav_dir)
    paths = synth.write_audio_files(wav_dir, 64, (1.0, 8.0), seed=11)
    lst, mlf = os.path.join(tmp, "list.scp"), os.path.join(tmp, "out.mlf")
    with open(lst, "w") as f:
        f.write("".join(p + "\n" for p in paths))
    for k in BATCH_KERNELS:
        KERNELS[k]["module"].LAUNCHES = 0
    t = time.perf_counter()
    rc = cli.main(["-c", pkg, "-l", lst, "-m", mlf, "--device", str(dev)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {k: KERNELS[k]["module"].LAUNCHES for k in BATCH_KERNELS}
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
    return launches


def timed_batch(sr, dev, B: int = 1024) -> None:
    """BatchPipeline._core at batch B x 5 s, per-stage CUDA events; 8 rows
    again through the plain versions on the card."""
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
    phase("batch", batch=B, seconds_each=5, frames=max_frames,
          audio_s_per_s=B * 5 / wall, wall_s=wall, stage_ms=stages,
          max_memory_allocated_bytes=peak,
          labels_per_utt=float(np.mean([len(l) for l in labels])),
          plain_equal_rows=same)
    if not all(same):
        raise AssertionError("kernel labels differ from the plain versions")


def build_all() -> None:
    """One nvcc per kernel source, all started together."""
    t = time.perf_counter()

    def one(name):
        t0 = time.perf_counter()
        _build.build(name)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(KERNELS)) as ex:
        secs = dict(zip(KERNELS, ex.map(one, KERNELS)))
    for name in KERNELS:
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
    the EN KWS net: ragged n_valid (some 0, some partial), random n_dec,
    beam off and 8.0.  The same entries live (value > NEG / 2), and sink
    records and carry bit-equal on them.  Returns B's result and its
    beam-off output."""
    blk = netstep.build_net_block_fn(dense)
    if blk is None:
        raise AssertionError("the structure gate rejected the EN KWS net")
    rng = np.random.default_rng(21)
    obs = torch.from_numpy(rng.normal(-3, 2, (F, n, dense.E))
                           .astype(np.float32)).to(dev)
    nv = rng.integers(1, F + 1, n)
    nv[::7] = 0
    nv[1::5] = F
    n_valid = torch.from_numpy(nv.astype(np.int32)).to(dev)
    n_dec = torch.from_numpy(rng.integers(0, 5000, n).astype(np.int32)
                             ).to(dev)
    carry0 = dense.init_carry(n, dev)
    out = {}
    for bw in (float(OFF_BEAM), 8.0):
        beam = torch.full((n,), bw, device=dev)
        args = (carry0, obs, n_valid, n_dec, beam)
        ck, (svk, swk) = blk(*args)
        cp, (svp, swp) = netstep.net_block_plain(dense, *args)
        torch.cuda.synchronize()
        live = svp > NEG / 2
        a_live = cp[0] > NEG / 2
        e_live = cp[2] > NEG / 2
        # both write never-winning values below NEG / 2 on dead paths, so
        # the kernel must make live exactly what the plain version does
        checks = {"sink_live": torch.equal(svk > NEG / 2, live),
                  "alpha_live": torch.equal(ck[0] > NEG / 2, a_live),
                  "entry_live": torch.equal(ck[2] > NEG / 2, e_live),
                  "sink_val": _live_equal(svk, svp, live),
                  "sink_wt": _live_equal(swk, swp, live),
                  "alpha": _live_equal(ck[0], cp[0], a_live),
                  "wt": _live_equal(ck[1], cp[1], a_live),
                  "entry": _live_equal(ck[2], cp[2], e_live),
                  "entry_wt": _live_equal(ck[3], cp[3], e_live)}
        t_k = cuda_ms(lambda: blk(*args))
        t_p = cuda_ms(lambda: netstep.net_block_plain(dense, *args),
                      iters=2, warmup=1)
        phase("netstep", n=n, F=F, M=dense.M, E=dense.E, S=dense.n_sinks,
              beam=bw, live_sink_share=float(live.float().mean()),
              bit_equal=checks, ms=t_k, plain_ms=t_p)
        if not all(checks.values()):
            raise AssertionError(f"netstep beam={bw}: {checks}")
        out[bw] = dict(max_abs_err=0.0, ms=t_k, plain_ms=t_p,
                       sinks=(svk, swk), n_valid=n_valid, n_dec=n_dec)
    return out


def check_lrtrace(c, b_out, dev, n: int = 256, F: int = 512):
    """Kernel F against its plain version, every field equal: on kernel
    B's beam-off output, and on sink records built to emit often
    (random-walk LRs with dead stretches), time_pruning 40 and off."""
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
                res = dict(max_abs_err=0.0, ms=t_k, plain_ms=t_p)
    return res


def hit_key(labels):
    return [(l.start_frames, l.end_frames, l.name) for l in labels]


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


def kws_vs_cpu(en_sr, en_cpu, dev, n: int = 4, seconds: float = 10.0):
    """4 streams x 10 s fed in chunks through process() on the card, then
    the CPU port (plain versions) on the same audio, decoding the card's
    log-posteriors: hits equal.  The CPU port's own log-posteriors are
    held to the card's within TOL_KWS_LP."""
    fs = en_sr.cfg.get_int("source", "sample_freq")
    rng = np.random.default_rng(31)
    streams = [synth.synth_audio(rng, int((seconds - i) * fs), fs)
               .astype("<i2").tobytes() for i in range(n)]

    def feed(ms):
        for off in range(0, max(map(len, streams)), 32000):
            for i, x in enumerate(streams):
                if off < len(x):
                    ms.process(i, x[off: off + 32000])
                elif not ms._ended[i]:
                    ms.end_stream(i)
        return ms.finish()

    for k in KWS_KERNELS:
        KERNELS[k]["module"].LAUNCHES = 0
    gpu = _Capture(en_sr, n, block_frames=512)
    got = feed(gpu)
    torch.cuda.synchronize()
    launches = {k: KERNELS[k]["module"].LAUNCHES for k in KWS_KERNELS}
    cpu = _Replay(gpu.lps, en_cpu, n, block_frames=512)
    want = feed(cpu)
    same = [hit_key(a) == hit_key(b) for a, b in zip(got, want)]
    score_err = max((abs(x.score - y.score) for a, b in zip(got, want)
                     for x, y in zip(a, b)), default=0.0)
    phase("kws_vs_cpu", streams=n, seconds=seconds, block_frames=512,
          net_path=gpu.net_path, launches=launches,
          hits=[len(h) for h in got], hits_equal=same,
          max_score_err=score_err, max_lp_err_cpu_vs_card=cpu.err,
          tol_lp=TOL_KWS_LP)
    if gpu.net_path != "kernel_b" or not all(launches.values()):
        raise AssertionError(f"KWS path skipped a kernel: {launches}")
    if not all(same) or score_err > 0.0:
        raise AssertionError("card KWS hits differ from the CPU port's")
    if not cpu.err <= TOL_KWS_LP:
        raise AssertionError(f"log-posteriors differ by {cpu.err}")


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
    for k in KWS_KERNELS:
        KERNELS[k]["module"].LAUNCHES = 0
    ms, hits, _, _ = one_pass()
    torch.cuda.synchronize()
    launches = {k: KERNELS[k]["module"].LAUNCHES for k in KWS_KERNELS}
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


def device_busy_share(fn):
    """Share of one run's wall in which some CUDA kernel or copy ran, from
    torch.profiler; None if the trace holds no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == DeviceType.CUDA and e.time_range.end >
        e.time_range.start)
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
    return dict(busy_us=busy, wall_us=wall_us, share=busy / wall_us)


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

    with tempfile.TemporaryDirectory() as tmp:
        pkg = synth.write_lcrc_package(os.path.join(tmp, "cz"), "cz", seed=0)
        sr = SpeechRec(pkg, device=dev)
        cpu_sr = SpeechRec(pkg, device="cpu")
        results = {"mlp_fused": check_mlp(sr, dev)}
        results["phnloop_viterbi"], results["backtrack"] = \
            check_viterbi_backtrack(dev)
        launches = run_cli(pkg, tmp, cpu_sr, dev)
        timed_batch(sr, dev)

        en = synth.write_kws_package(os.path.join(tmp, "en"), "en", seed=0)
        en_sr = SpeechRec(en, device=dev)
        en_cpu = SpeechRec(en, device="cpu")
        check_mlp(en_sr, dev, shapes="en")
        dense = DenseKWSScan(en_sr.stk_decoder.decoder)
        b_out = check_netstep(dense, dev)
        results["netstep"] = {k: v for k, v in b_out[float(OFF_BEAM)]
                              .items() if k in ("max_abs_err", "ms",
                                                "plain_ms")}
        results["lrtrace"] = check_lrtrace(en_sr.stk_decoder.compiled,
                                           b_out[float(OFF_BEAM)], dev)
        kws_vs_cpu(en_sr, en_cpu, dev)
        launches.update(
            {k: v for k, v in kws_serving(en_sr, dev).items()
             if k in ("netstep", "lrtrace")})

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
