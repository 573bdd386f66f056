"""Compare variants of the training scans' source (csrc/trainfb.cu: kernels
J, K and K') on one CUDA card.

    python3 -m phnrec_tpu_torch.devtools.trainfb_variants [--sweep] \\
        [--clusters] [--repeat N] REF.cu [VARIANT.cu ...]

Builds every source given (all at once, with the package's nvcc flags, into
build/phnrec_tpu_torch/variants/), prints each build's registers and
spills, and holds each to the plain versions (ops/phnloop_fb.py,
ops/trainfb.py) on the case list that chip_smoke.py holds the package's
kernels to (``check_cases``): J on loops of 4 x 3 to 2,100 x 3 states
(past 1,024 threads, and with its carries in device memory), K and K' on
padded training graphs of netgen's PDFObsVec HMM set over 46 phonemes at S
32 to 6,304 (``K_CASES``: the one-block kernels' carries in device memory
at 6,304; the cluster kernels' largest S and the next bucket past it), B 1
to 160, ragged n_frames, tie-heavy observations; J and K within TOL relative (of
max(|x|, 1)), K' bit for bit.  Then it times every build in turns (first
to last, then last to first) at the training path's shapes (J: one CZ
utterance, B 1 x T 500 x 46 x 3; K and K': a bucket, B 16 x T 512 x S 256
with n 385-512) by chip_smoke.py's two timers.  The parent's source is
extracted by the caller, e.g.
``git show HEAD~1:phnrec_tpu_torch/csrc/trainfb.cu > build/trainfb_ref.cu``.
``--repeat N`` runs the case list N times a build (a race between the
threads shows only sometimes); ``--sweep`` times K and K' again at B 1, 16
and 128 (the bucket cut to one utterance, and repeated: the chain's
latency against the traffic of all the chains); ``--clusters`` times the
cluster kernels of the builds that have them at B 1 and 16 on each
cluster size, beside their one-block kernels.  A build's one-block K and
K' are held to the plain versions on every case as well, and its K on a
cluster is compared bit for bit with its one-block K (reported).  One
JSON line per build, check and timing.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from phnrec_tpu_torch.devtools.mlp_variants import build, cuda_ms
from phnrec_tpu_torch.devtools.scan_variants import held_ms
from phnrec_tpu_torch.io.mmf import parse_mmf
from phnrec_tpu_torch.netgen import phn_list_to_hmm_defs
from phnrec_tpu_torch.ops import phnloop_fb, trainfb
from phnrec_tpu_torch.train.graph import (build_model_index,
                                          compile_transcription, pad_graph)

# J and K against their plain versions: float32 lses summed in another
# order; relative to max(|x|, 1)
TOL = 1e-5
# the phoneme-loop scan's arguments after P and S: w_penalty, tr_curr,
# tr_next (the CZ package's penalty, netgen's 0.5 transitions)
J_ARGS = (-1.5, float(np.log(0.5)), float(np.log(0.5)))
# (P, S, B, T): tiny, the CZ loop at B 1 and 16, past 1,024 threads, and
# past 48 KB of carries (device memory)
J_CASES = ((4, 3, 1, 40), (46, 3, 1, 500), (46, 3, 16, 500),
           (400, 3, 2, 60), (2100, 3, 1, 12))
# (phonemes a transcription, S, B, T, ties): S 32, the CZ bucket (256) at
# B 1 and 16, ties, past 512 columns, past 48 KB of carries; then the
# phoneme-loop denominator of sMBR (S 138, B 1), S 250 (no multiple of a
# cluster size), the clusters' largest S at c 8 (640, B 16) and at c 16
# (928, B 1), the next bucket past it (960: the one-block kernels), and
# more clusters than the card holds at once (B 32 and 160)
K_CASES = ((10, 32, 16, 64, False), (78, 256, 1, 200, False),
           (78, 256, 16, 512, False), (78, 256, 16, 128, True),
           (200, 608, 2, 40, False), (2100, 6304, 1, 10, True),
           (45, 138, 1, 300, False), (83, 250, 4, 96, True),
           (213, 640, 16, 40, False), (309, 928, 1, 32, True),
           (319, 960, 1, 32, False), (78, 256, 32, 96, False),
           (78, 256, 160, 24, True))


def hmm_set(tmp: str, phonemes):
    """netgen's PDFObsVec HMM set over ``phonemes`` (3 emitting states, the
    posterior columns in list order, 0.5/0.5 transitions)."""
    lst = os.path.join(tmp, "train_phonemes")
    mmf = os.path.join(tmp, "train_hmms.mmf")
    with open(lst, "w") as f:
        f.write("".join(p + "\n" for p in phonemes))
    phn_list_to_hmm_defs(lst, mmf, 3)
    return parse_mmf(mmf)


def _round_up(n: int, m: int) -> int:
    return max(-(-n // m) * m, m)


def graph_batch(models, transcriptions, S: int, dev):
    """Training graphs of ``transcriptions``, padded to S states, as K's
    [B, S, S] / [B, S] tensors on ``dev``."""
    idx = build_model_index(models)
    gs = [pad_graph(g, S, _round_up(len(g.e_src), 128),
                    _round_up(len(g.en_state), 32),
                    _round_up(len(g.ex_state), 32))
          for g in (compile_transcription(models, t, idx)
                    for t in transcriptions)]
    return [torch.from_numpy(np.stack([getattr(g, f) for g in gs])).to(dev)
            for f in ("log_A", "log_entry", "log_exit")]


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max(|want|, 1) (inf where one is not finite and
    the other is)."""
    if not torch.equal(torch.isfinite(got), torch.isfinite(want)):
        return math.inf
    fin = torch.isfinite(want)
    d = (got - want).abs() / want.abs().clamp(min=1.0)
    return float(d[fin].max()) if bool(fin.any()) else 0.0


def abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over the entries above -1e29 (the reached ones:
    unreached ones hold -1e30 or -FLT_MAX sums, compared by rel_err)."""
    live = want > -1e29
    return float((got - want)[live].abs().max()) if bool(live.any()) else 0.0


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def logpost(rng, B, T, D, dev, ties=False) -> torch.Tensor:
    """[B, T, D] seeded log-posteriors (``ties``: multiples of -1/4)."""
    if ties:
        return torch.from_numpy(
            -rng.integers(0, 6, (B, T, D)).astype(np.float32) / 4).to(dev)
    x = rng.standard_normal((B, T, D)).astype(np.float32) * 2
    return torch.from_numpy(
        x - np.log(np.exp(x).sum(-1, keepdims=True))).to(dev)


def check_graphs(fb, align, args, n, fb_one=None, align_one=None) -> dict:
    """Kernels ``fb`` (K's signature) and ``align`` (K''s) on one batch of
    graphs (``args``: log_A, log_entry, log_exit, log_b; ``n`` the frames)
    against the plain versions: K's worst relative and absolute errors,
    whether its outputs are finite and whether K' is bit-equal.  With
    ``fb_one`` and ``align_one``, the one-block design's K and K' too,
    held the same way (``one_block_rel_err``, ``one_block_abs_err``,
    ``one_block_align_bit_equal``), and whether ``fb`` equals ``fb_one`` bit for bit
    (``fb_bit_equal_one_block``)."""
    got = fb(*args, n)
    want = trainfb.graph_fb_plain(*args, n)
    st, ll = align(*args, n)
    st_p, ll_p = trainfb.graph_align_plain(*args, n)
    torch.cuda.synchronize()
    rec = dict(rel_err=max(rel_err(g, w) for g, w in zip(got, want)),
               abs_err=max(abs_err(g, w) for g, w in zip(got, want)),
               align_bit_equal=torch.equal(st, st_p) and bits_equal(ll, ll_p),
               finite=bool(all(torch.isfinite(g).all() for g in got)))
    if fb_one is not None:
        one = fb_one(*args, n)
        st_o, ll_o = align_one(*args, n)
        torch.cuda.synchronize()
        rec.update(
            one_block_rel_err=max(rel_err(o, w) for o, w in zip(one, want)),
            one_block_abs_err=max(abs_err(o, w) for o, w in zip(one, want)),
            one_block_align_bit_equal=(torch.equal(st_o, st_p)
                                       and bits_equal(ll_o, ll_p)),
            fb_bit_equal_one_block=all(bits_equal(g, o)
                                       for g, o in zip(got, one)))
    return rec


def graphs_ok(rec: dict) -> bool:
    """Whether a ``check_graphs`` record holds: K (and its one-block
    design) within TOL, finite, K' (both designs) bit-equal."""
    return (rec["finite"] and rec["align_bit_equal"] and rec["rel_err"] <= TOL
            and rec.get("one_block_rel_err", 0.0) <= TOL
            and rec.get("one_block_align_bit_equal", True))


def check_cases(j, fb, align, dev, models, seed: int = 21,
                fb_one=None, align_one=None) -> dict:
    """Kernels ``j`` (J's signature), ``fb`` (K's) and ``align`` (K''s)
    against the plain versions on J_CASES and K_CASES: the case records,
    the worst relative and absolute errors of J and K, and whether K' was
    bit-equal everywhere.  ``fb_one`` and ``align_one``, when given, are
    the one-block design's K and K': held to the plain versions on every
    case as well (``ok`` needs both designs), and whether ``fb`` equals
    ``fb_one`` bit for bit (``fb_bit_equal_one_block``, reported)."""
    rng = np.random.default_rng(seed)
    names = list(models.hmms)
    recs = []
    rel = {"phnloop_fb": 0.0, "graph_fb": 0.0}
    ab = {"phnloop_fb": 0.0, "graph_fb": 0.0}
    for P, S, B, T in J_CASES:
        lp = logpost(rng, B, T, P * S + 2, dev)
        got = j(lp, P, S, *J_ARGS)
        want = phnloop_fb.phnloop_fb_plain(lp, P, S, *J_ARGS)
        torch.cuda.synchronize()
        err = max(rel_err(g, w) for g, w in zip(got, want))
        rel["phnloop_fb"] = max(rel["phnloop_fb"], err)
        ab["phnloop_fb"] = max(ab["phnloop_fb"], max(
            abs_err(g, w) for g, w in zip(got, want)))
        recs.append(dict(kernel="phnloop_fb", P=P, S=S, B=B, T=T,
                         rel_err=err))
    ok = rel["phnloop_fb"] <= TOL
    for n_phn, S, B, T, ties in K_CASES:
        trans = [list(rng.choice(names, n_phn - int(rng.integers(0, 3))))
                 for _ in range(B)]
        args = (*graph_batch(models, trans, S, dev),
                logpost(rng, B, T, S, dev, ties))
        ns = rng.integers(1, T + 1, B)
        ns[0] = T
        n = torch.from_numpy(ns.astype(np.int32)).to(dev)
        rec = dict(kernel="graph_fb+graph_align", S=S, B=B, T=T, ties=ties,
                   **check_graphs(fb, align, args, n, fb_one, align_one))
        rel["graph_fb"] = max(rel["graph_fb"], rec["rel_err"],
                              rec.get("one_block_rel_err", 0.0))
        ab["graph_fb"] = max(ab["graph_fb"], rec["abs_err"])
        ok = ok and graphs_ok(rec)
        recs.append(rec)
    k_recs = recs[len(J_CASES):]
    out = dict(cases=recs, rel_err=rel, max_abs_err=ab,
               align_bit_equal=all(r["align_bit_equal"] for r in k_recs),
               ok=ok)
    if fb_one is not None:
        out["one_block_ok"] = all(
            r["one_block_rel_err"] <= TOL and r["one_block_align_bit_equal"]
            for r in k_recs)
        out["fb_bit_equal_one_block"] = all(
            r["fb_bit_equal_one_block"] for r in k_recs)
    return out


def timing_inputs(dev, models, seed: int = 22) -> dict:
    """The training path's shapes: J's one CZ utterance (B 1 x T 500 x 46
    x 3) and K's bucket (B 16 x T 512 x S 256 of 78-phoneme
    transcriptions, n 385-512)."""
    rng = np.random.default_rng(seed)
    names = list(models.hmms)
    trans = [list(rng.choice(names, 78)) for _ in range(16)]
    ns = rng.integers(385, 513, 16)
    return dict(
        j=(logpost(rng, 1, 500, 138, dev), 46, 3, *J_ARGS),
        k=(*graph_batch(models, trans, 256, dev),
           logpost(rng, 16, 512, 256, dev),
           torch.from_numpy(ns.astype(np.int32)).to(dev)),
        ns=ns)


# the B sweep: the timing bucket cut to its first utterance, as it is,
# and repeated 8 times
SWEEP_B = (1, 16, 128)


def replicate(k, B: int) -> tuple:
    """K's bucket arguments ``k`` cut to, or repeated up to, B
    utterances."""
    reps = -(-B // k[0].shape[0])
    return tuple(torch.cat([a] * reps)[:B].contiguous() for a in k)


def step_us(ms: float, T: int, align: bool) -> float:
    """Microseconds a frame step: K takes 2T steps (forwards and
    backwards), K' T."""
    return ms * 1e3 / (T if align else 2 * T)


def cluster_sweep(libs: dict, k, order) -> None:
    """K and K' of every build with cluster kernels at B 1 and 16 on each
    cluster size the card holds, and on the one-block kernels (c 0): held
    ms in turns (``order``), and the card's clusters at once by size."""
    S, T = k[0].shape[-1], k[3].shape[1]
    dev = k[0].device
    rows = {}
    for B in (1, 16):
        kb = replicate(k, B)
        for name in order:
            lib = libs[name]
            if not hasattr(lib, "graph_fb_cluster"):
                continue
            act = {w: trainfb.max_active(lib, w, S, dev) for w in (False,
                                                                  True)}
            for c in (0, *trainfb.CLUSTER_SIZES):
                if c and not act[False][c]:
                    continue
                r = rows.setdefault((name, B, c), {
                    "K": [], "K'": [], "max_active": act[False].get(c),
                    "plan": trainfb.plan(lib, False, B, S, dev)})
                r["K"].append(held_ms(lambda: trainfb.launch_fb(
                    lib, *kb, cluster=c), iters=3))
                r["K'"].append(held_ms(lambda: trainfb.launch_align(
                    lib, *kb, cluster=c), iters=3))
    for (name, B, c), r in rows.items():
        print(json.dumps({"cluster_sweep": name, "B": B, "c": c, "S": S,
                          "T": T, **r, "step_us": {
                              w: [step_us(v, T, w == "K'") for v in r[w]]
                              for w in ("K", "K'")}}), flush=True)


def sweep(libs: dict, calls, k, order) -> None:
    """K and K' of every build at B 1, 16 and 128 (``replicate``), held
    ms and us a frame step, in turns (``order``)."""
    T = k[3].shape[1]
    rows = {(n, B): {"K": [], "K'": []} for n in libs for B in SWEEP_B}
    for B in SWEEP_B:
        kb = replicate(k, B)
        for name in order:
            c = calls(libs[name])
            rows[name, B]["K"].append(held_ms(lambda: c["fb"](*kb), iters=3))
            rows[name, B]["K'"].append(
                held_ms(lambda: c["align"](*kb), iters=3))
    for (name, B), t in rows.items():
        print(json.dumps({"sweep": name, "B": B, "T": T, "held_ms": t,
                          "step_us": {w: [step_us(v, T, w == "K'")
                                          for v in ts]
                                      for w, ts in t.items()}}), flush=True)


def main(argv) -> int:
    argv = list(argv)
    do_sweep = "--sweep" in argv
    do_clusters = "--clusters" in argv
    repeat = 1
    if "--repeat" in argv:
        i = argv.index("--repeat")
        repeat = int(argv[i + 1])
        del argv[i: i + 2]
    argv = [a for a in argv if a not in ("--sweep", "--clusters")]
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
    srcs = {f"{i}:{Path(a).stem}": Path(a) for i, a in enumerate(argv)}
    with ThreadPoolExecutor(len(srcs)) as ex:
        libs = dict(zip(srcs, ex.map(build, srcs, srcs.values())))
    for lib in libs.values():
        trainfb.bind(lib)

    def calls(lib):
        return dict(
            j=lambda *a: phnloop_fb.launch(lib, *a),
            fb=lambda *a: trainfb.launch_fb(lib, *a),
            align=lambda *a: trainfb.launch_align(lib, *a))

    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        models = hmm_set(tmp, [f"ph{i:02d}" for i in range(46)])
        for name, lib in libs.items():
            one = {}
            if hasattr(lib, "graph_fb_cluster"):
                one = dict(
                    fb_one=lambda *a, lib=lib: trainfb.launch_fb(
                        lib, *a, cluster=0),
                    align_one=lambda *a, lib=lib: trainfb.launch_align(
                        lib, *a, cluster=0))
                print(json.dumps({"max_active": name, "S": 256, **{
                    w: trainfb.max_active(lib, w == "K'", 256, dev)
                    for w in ("K", "K'")}}), flush=True)
            for _ in range(repeat):
                res = check_cases(**calls(lib), dev=dev, models=models,
                                  **one)
                ok = ok and res["ok"]
                print(json.dumps({"check": name, **res}), flush=True)
        inp = timing_inputs(dev, models)
    timers = {"ms": cuda_ms, "held_ms": held_ms}
    ms = {name: {f"{k} {w}": [] for k in ("J", "K", "K'") for w in timers}
          for name in libs}
    for name in [*libs, *reversed(libs)]:
        c = calls(libs[name])
        fns = {"J": lambda: c["j"](*inp["j"]),
               "K": lambda: c["fb"](*inp["k"]),
               "K'": lambda: c["align"](*inp["k"])}
        for k, fn in fns.items():
            for w, timer in timers.items():
                ms[name][f"{k} {w}"].append(timer(fn, iters=5))
    for name, t in ms.items():
        print(json.dumps({"time_ms": name, **t}), flush=True)
    if do_sweep:
        sweep(libs, calls, inp["k"], [*libs, *reversed(libs)])
    if do_clusters:
        cluster_sweep(libs, inp["k"], [*libs, *reversed(libs)])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
