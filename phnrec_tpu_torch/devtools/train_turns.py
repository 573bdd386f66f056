"""Cell 10's Baum-Welch accumulation pass timed in turns across checkouts of
the repo, on one CUDA card.

    python3 -m phnrec_tpu_torch.devtools.train_turns [--passes N] \\
        [--rounds R] TREE [TREE ...]

A TREE is the root of a checkout: ``.``, or an earlier commit unpacked
under build/ (``mkdir -p build/parent && git archive COMMIT | tar -x -C
build/parent``).  A process of its own runs in each TREE (``worker``,
with the TREE's package and chip_smoke.py on its path): it builds the
TREE's kernels, makes chip_smoke.py's posterior route at its size (256
seeded utterances of 5 s through the CZ LCRC package's batch pipeline,
netgen's PDFObsVec set over the 46 phonemes, each utterance transcribed
by its own labels), then runs N Baum-Welch accumulation passes of the
TREE's Reestimator over them (the first as the smoke's first iteration,
the rest warm).  A pass reports its wall, the card's ms by stage (CUDA
events at the Reestimator's hooks, summed over the buckets) and the
host's ms between the same hooks.  Where the TREE's chip_smoke.py has
``_time_setup`` (host timers on the graph work), the TREE runs twice a
turn, without and with them, and the passes with them report the graph
work by step.  The turns: the runs first to last, then last to first, R
rounds.  One JSON line a pass, then one a run with every pass's numbers
side by side; the lines are also written to chiprun_out/train_turns.jsonl.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# a run's process: this file run as ``__worker__`` with the TREE's
# package and chip_smoke.py first on the path (``-c`` puts the current
# directory there); its arguments: TREE, host timers (0 or 1), passes
_WORKER = "import runpy; runpy.run_path({path!r}, run_name='__worker__')"


def posterior_inputs(sr, B: int = 256, seconds: float = 5.0,
                     seed: int = 31):
    """The posterior route's inputs (chip_smoke.py's train_posteriors): B
    seeded utterances of ``seconds`` through ``sr``'s batch pipeline on
    the card.  (utterances as (log-posteriors, label names) pairs on the
    host, the log-posteriors on the card, the frame counts, the labels.)"""
    import numpy as np
    from phnrec_tpu_torch import synth
    from phnrec_tpu_torch.decoder import phnloop
    rng = np.random.default_rng(seed)
    L = int(seconds * 8000)
    bp = sr.batch_pipeline
    waves = [synth.synth_audio(rng, L).astype(np.float32) for _ in range(B)]
    w, nf, mf, ns = bp.to_device(*bp.pad_batch(waves))
    lp = bp._post_core(w, nf, mf, ns)
    n_frames = nf.cpu().numpy()
    labels = phnloop.labels_from_segments(
        phnloop.fetch_segments(bp._core(w, nf, mf, ns)), n_frames,
        sr.phonemes)
    lp_host = lp.cpu().numpy()
    utts = [(lp_host[b, : n_frames[b]], [l.name for l in labels[b]])
            for b in range(B)]
    return utts, lp, n_frames, labels


def timed_pass(models, utts, dev, time_setup=None) -> dict:
    """One Baum-Welch pass of a Reestimator over ``utts``: wall s, the
    card's and the host's ms by stage, and (``time_setup``:
    chip_smoke._time_setup) the host's graph work by step."""
    import torch
    from phnrec_tpu_torch.train.loop import Reestimator
    re_ = Reestimator(models, mode="baum_welch", batch_size=16, device=dev)
    marks, host_ms, setup = [], {}, {}
    last = [torch.cuda.Event(enable_timing=True), 0.0]
    last[0].record()

    def hook(stage):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        now = time.perf_counter()
        marks.append((stage, last[0], ev))
        host_ms[stage] = host_ms.get(stage, 0.0) + (now - last[1]) * 1e3
        last[0], last[1] = ev, now
    re_.stage_hook = hook
    undo = time_setup(re_, setup) if time_setup is not None else None
    torch.cuda.synchronize()
    t = last[1] = time.perf_counter()
    try:
        for x, names in utts:
            re_.add_utterance(x, names)
        re_.finish()
        torch.cuda.synchronize()
    finally:
        if undo is not None:
            undo()
    wall = time.perf_counter() - t
    card = {}
    for stage, a, b in marks:
        card[stage] = card.get(stage, 0.0) + a.elapsed_time(b)
    return dict(wall_s=wall, stage_ms=card, stage_host_ms=host_ms,
                setup_host_ms=setup or None,
                log_like=float(re_.total_log_like))


def worker(tree: str, timers: bool, passes: int) -> None:
    """One run in the current directory's checkout: its kernels built, the
    posterior route's utterances made, ``passes`` timed passes (with the
    host timers where ``timers``); a JSON line each."""
    import torch
    import chip_smoke as c
    from phnrec_tpu_torch import synth
    from phnrec_tpu_torch.devtools import trainfb_variants
    from phnrec_tpu_torch.ops import trainfb
    from phnrec_tpu_torch.pipeline import SpeechRec
    c.build_all()
    dev = torch.device("cuda", 0)
    trainfb._lib()
    with tempfile.TemporaryDirectory() as tmp:
        sr = SpeechRec(synth.write_lcrc_package(tmp + "/cz", "cz", seed=0),
                       device=dev)
        utts = posterior_inputs(sr)[0]
        models = trainfb_variants.hmm_set(tmp, sr.phonemes)
        for p in range(passes):
            r = timed_pass(models, utts, dev,
                           c._time_setup if timers else None)
            print(json.dumps({"tree": tree, "host_timers": timers,
                              "pass": p, **r}), flush=True)


def main(argv) -> int:
    argv = list(argv)
    opts = {"--passes": 3, "--rounds": 1}
    for k in opts:
        if k in argv:
            i = argv.index(k)
            opts[k] = int(argv[i + 1])
            del argv[i: i + 2]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("ERROR: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    runs = []
    for tree in argv:
        has = "def _time_setup(" in (Path(tree) / "chip_smoke.py").read_text()
        runs += [(tree, False)] + ([(tree, True)] if has else [])
    order = (runs + runs[::-1]) * opts["--rounds"]
    me = str(Path(__file__).resolve())
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    rows: dict = {}
    ok = True
    with open(out_dir / "train_turns.jsonl", "w") as log:
        for tree, timers in order:
            cmd = [sys.executable, "-c", _WORKER.format(path=me), tree,
                   str(int(timers)), str(opts["--passes"])]
            p = subprocess.run(cmd, cwd=tree, capture_output=True,
                               text=True, timeout=900)
            if p.returncode:
                ok = False
                print(json.dumps({"tree": tree, "host_timers": timers,
                                  "rc": p.returncode,
                                  "stderr": p.stderr[-3000:]}), flush=True)
                continue
            for line in p.stdout.splitlines():
                r = json.loads(line) if line.startswith("{") else {}
                if "pass" not in r:         # the build's lines
                    continue
                print(line, flush=True)
                log.write(line + "\n")
                rows.setdefault((tree, timers), []).append(r)
        for (tree, timers), rs in rows.items():
            first = [r for r in rs if r["pass"] == 0]
            warm = [r for r in rs if r["pass"] > 0]
            summary = {"summary": tree, "host_timers": timers}
            for name, part in (("first", first), ("warm", warm)):
                summary[name] = {
                    "wall_s": [r["wall_s"] for r in part],
                    "stage_ms": {k: [r["stage_ms"].get(k) for r in part]
                                 for k in part[0]["stage_ms"]} if part
                    else {},
                    "stage_host_ms": {
                        k: [r["stage_host_ms"].get(k) for r in part]
                        for k in part[0]["stage_host_ms"]} if part else {}}
            line = json.dumps(summary)
            print(line, flush=True)
            log.write(line + "\n")
    return 0 if ok else 1


if __name__ == "__worker__":
    worker(sys.argv[1], sys.argv[2] == "1", int(sys.argv[3]))
elif __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
