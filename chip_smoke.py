#!/usr/bin/env python3
"""Smoke test of phnrec_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the three CUDA kernels from phnrec_tpu_torch/csrc, holds each against
its plain PyTorch version on the card at the main path's shapes, drives the
batch wav->rec path once through the CLI on a synthetic package at the CZ
SpeechDat LCRC shapes (64 files), times a batch of 1024 x 5 s, and prints
one JSON line of kernel results, the card's name and power limit, and a last
line {"ok": true, "device": {...}}.  Any failed phase raises and the script
exits non-zero; without a CUDA card it exits non-zero before any result.
Imports neither JAX nor phnrec_tpu.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from phnrec_tpu_torch import synth
from phnrec_tpu_torch.decoder import phnloop
from phnrec_tpu_torch.io.labels import read_mlf
from phnrec_tpu_torch.ops import _build, backtrack, mlp_fused, phnloop_viterbi
from phnrec_tpu_torch.pipeline import SpeechRec

KERNELS = {
    "mlp_fused": dict(module=mlp_fused, source="phnrec_tpu_torch/csrc/mlp_fused.cu",
                      replaces="phnrec_tpu/ops/pallas_mlp.py:175"),
    "phnloop_viterbi": dict(module=phnloop_viterbi,
                            source="phnrec_tpu_torch/csrc/phnloop_viterbi.cu",
                            replaces="phnrec_tpu/decoder/phnloop.py:79"),
    "backtrack": dict(module=backtrack, source="phnrec_tpu_torch/csrc/backtrack.cu",
                      replaces="phnrec_tpu/decoder/phnloop.py:375"),
}
# kernel A against cuBLAS float32: both sum in another order, and fexp is a
# step function of its argument (steps of 2^-20 relative), so outputs differ
# by a few ulp of the sums; probabilities within 2e-5, raw logits within 1e-4
TOL_SOFTMAX = 2e-5
TOL_LOGITS = 1e-4


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


def check_mlp(sr, dev) -> dict:
    """Kernel A against its plain version at the three CZ nets."""
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
            phase("mlp_fused", net=name, rows=n,
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
    for k in KERNELS.values():
        k["module"].LAUNCHES = 0
    t = time.perf_counter()
    rc = cli.main(["-c", pkg, "-l", lst, "-m", mlf, "--device", str(dev)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {name: k["module"].LAUNCHES for name, k in KERNELS.items()}
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

    t = time.perf_counter()
    for name in KERNELS:
        t0 = time.perf_counter()
        _build.load(name)
        log = _build.build_log(name) or "(cached)"
        info = [l.strip() for l in log.splitlines()
                if "registers" in l or "spill" in l]
        phase("build", kernel=name, seconds=time.perf_counter() - t0,
              ptxas=info)
    phase("build_total", seconds=time.perf_counter() - t)

    with tempfile.TemporaryDirectory() as tmp:
        pkg = synth.write_lcrc_package(os.path.join(tmp, "cz"), "cz", seed=0)
        sr = SpeechRec(pkg, device=dev)
        cpu_sr = SpeechRec(pkg, device="cpu")
        results = {"mlp_fused": check_mlp(sr, dev)}
        results["phnloop_viterbi"], results["backtrack"] = \
            check_viterbi_backtrack(dev)
        launches = run_cli(pkg, tmp, cpu_sr, dev)
        timed_batch(sr, dev)

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
