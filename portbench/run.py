"""Run one benchmark cell of phnrec_tpu_torch once and print its result.

    python3 -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  Everything a cell needs is found by name
from ``BENCHMARK.json``: the configuration's file, the traffic mix
``portbench/mixes/<traffic>.json`` (whose ``kind`` picks a driver:
``traffic.driver_for``), the correctness limits
``portbench/limits/<cell>.json``, and each per-layer metric's reader
``portbench/metrics/<metric>.py``.  The configuration names its plain
reference, ``portbench/references/<reference>.py``, and may name its
package writer, ``portbench/writers/<writer>.py`` (else
``portbench/writer.py``); the reference's ``model_macs_per_frame``, where
it has one, counts the model's work (else ``portbench/work.py``'s).  The
map from the profiler's kernel names to the port's kernels is
``portbench/kernels.json`` merged with every ``portbench/kernels/*.json``;
the program's functions that the traced run wraps in spans and launch
records are ``portbench/hooks.json`` merged with every
``portbench/hooks/*.json``.  So a cell of a new kind is added as new
files and manifest entries alone.

Set-up (``setup_s``, from the first statement of this file): torch and
the card, the package written from the seed, the cell's inputs, the
program loaded (its kernels from the hashed build directory inside the
checkout) and the window's shapes run once.  The window then runs for
``--seconds``.  ``--trace 0`` prints the cell's end-to-end metrics;
``--trace 1`` runs the window under torch.profiler and prints its
per-layer metrics, the device's busy time and a breakdown.  Either way,
once the window has closed and the program's state is freed, a sample of
what the program produced is judged by the plain reference, and each
number compared is printed beside its limit, last on standard error and
last in the result line.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import NamedTuple  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "phnrec_tpu")


def forbidden_modules(modules) -> list:
    """The loaded modules' top-level names, compared whole, that belong
    to JAX or the JAX package."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


class Spans:
    """Host spans by name (seconds), recorded only in a traced run, where
    each is also a profiler range that names what the host was doing."""

    def __init__(self, on: bool):
        self.on = on
        self.seconds = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        import torch
        with torch.profiler.record_function(name):
            t = time.perf_counter()
            try:
                yield
            finally:
                self.seconds[name].append(time.perf_counter() - t)


class Trace:
    """What the per-layer readers read: the window's length, the device's
    busy time, device seconds by kernel, the launches' shapes by kernel,
    host spans, the seconds of each of the window's items (passes,
    rounds), the valid frames, the configuration, the model's FLOPs, and
    the driver's own figures (``extra``: whatever its window returned
    beyond ``WINDOW_KEYS``)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


# what every driver's window returns; the rest is the driver's own
WINDOW_KEYS = ("wall_s", "item_s", "attempted", "failed", "valid_frames",
               "metrics")


class Launch(NamedTuple):
    """One call of a function named under the hooks' ``launches``: the
    shapes of its tensor arguments, positional ones in order, then
    keyword ones; its int, float and bool positional arguments in order;
    and its int, float and bool keyword arguments by name."""

    shapes: tuple
    scalars: tuple
    named: dict


def json_layers(root: Path, name: str) -> list:
    """(path, content) of ``portbench/<name>.json``, then of every
    ``portbench/<name>/*.json`` in sorted order."""
    base = root / "portbench"
    paths = [base / f"{name}.json"] + sorted((base / name).glob("*.json"))
    return [(p.relative_to(root).as_posix(), json.loads(p.read_text()))
            for p in paths]


def _add_once(into: dict, owner: dict, part: dict, path: str,
              what: str) -> None:
    """``part``'s keys into ``into``; a key that ``owner`` already holds
    (a file that gave it before) fails, naming both files."""
    for k, v in part.items():
        if k in owner:
            raise ValueError(f"{what} {k!r} is given in both {owner[k]} "
                             f"and {path}")
        owner[k] = path
        into[k] = v


def load_kernels(root: Path) -> dict:
    """Kernel key -> the profiler names' parts it sums:
    ``portbench/kernels.json`` and every ``portbench/kernels/*.json``."""
    out, owner = {}, {}
    for path, part in json_layers(root, "kernels"):
        _add_once(out, owner, part, path, "kernel key")
    return out


HOOK_SECTIONS = ("spans", "mlp_launches", "launches")


def load_hooks(root: Path) -> dict:
    """``portbench/hooks.json`` and every ``portbench/hooks/*.json``
    merged: ``spans`` by name, their targets concatenated;
    ``mlp_launches`` (kernel A's launches, recorded as its rows and
    widths) and ``launches`` (any function: its ``Launch``), one key in
    one file only across both sections."""
    out, owner = {}, {}
    for path, part in json_layers(root, "hooks"):
        unknown = set(part) - set(HOOK_SECTIONS)
        if unknown:
            raise ValueError(f"{path}: no hook section "
                             f"{', '.join(sorted(unknown))}")
        for name, targets in part.get("spans", {}).items():
            spans = out.setdefault("spans", {})
            spans[name] = spans.get(name, []) + targets
        for section in HOOK_SECTIONS[1:]:
            if section in part:
                _add_once(out.setdefault(section, {}), owner,
                          part[section], path, "launch key")
    return out


def _resolve(target: str):
    """``module:attr`` or ``module:Class.attr`` -> (owner, attr)."""
    mod, path = target.split(":")
    owner = importlib.import_module(mod)
    *parents, attr = path.split(".")
    for p in parents:
        owner = getattr(owner, p)
    return owner, attr


def install_hooks(hooks: dict, spans: Spans, launches: dict) -> list:
    """Wrap the program's functions that the merged hooks name; returns
    how to undo it, in order (the last wrapper first)."""
    undo = []

    def wrap_span(fn, name):
        def wrapped(*a, **kw):
            with spans(name):
                return fn(*a, **kw)
        return wrapped

    def wrap_launch(fn, key):
        def wrapped(x, mean, dev, w1, b1, w2, b2, *a, **kw):
            launches[key].append((x.shape[0], w1.shape[0], w1.shape[1],
                                  w2.shape[1]))
            return fn(x, mean, dev, w1, b1, w2, b2, *a, **kw)
        return wrapped

    def wrap_record(fn, key):
        import torch
        scalar = (bool, int, float)

        def wrapped(*a, **kw):
            launches[key].append(Launch(
                tuple(tuple(v.shape) for v in (*a, *kw.values())
                      if isinstance(v, torch.Tensor)),
                tuple(v for v in a if isinstance(v, scalar)),
                {k: v for k, v in kw.items() if isinstance(v, scalar)}))
            return fn(*a, **kw)
        return wrapped

    for name, targets in hooks.get("spans", {}).items():
        for target in targets:
            mod, attr = _resolve(target)
            fn = getattr(mod, attr)
            undo.append((mod, attr, fn))
            setattr(mod, attr, wrap_span(fn, name))
    for section, wrap in (("mlp_launches", wrap_launch),
                          ("launches", wrap_record)):
        for key, target in hooks.get(section, {}).items():
            mod, attr = _resolve(target)
            fn = getattr(mod, attr)
            undo.append((mod, attr, fn))
            setattr(mod, attr, wrap(fn, key))
    return undo[::-1]


def gap_names(hooks: dict, spans: Spans) -> set:
    """The span names that ``read_profile`` names idle gaps by: the
    hooks' and the benchmark's, and the program's own, from its
    recorder's snapshot of the window."""
    from portbench.metrics._recorder import snapshot
    snap = snapshot()
    return set(hooks.get("spans", {})) | set(spans.seconds) | set(
        snap.spans if snap is not None else ())


def read_profile(prof, kernels: dict, span_names):
    """(busy seconds, device seconds by kernel key, the 10 device ops
    that took most, the idle gaps' seconds by what the host was doing: the
    innermost of the benchmark's spans, else the innermost torch op near
    it) from a torch.profiler run."""
    import bisect

    from portbench.work import gaps, union_s
    dev, cpu = [], []
    spans = {n: [] for n in span_names}
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if b <= a:
            continue
        if e.device_type.name == "CUDA":
            # a host range also shows on the device's timeline: not work
            if not e.is_user_annotation:
                dev.append((a, b, e.name))
        elif e.name in spans:
            spans[e.name].append((a, b))
        else:
            cpu.append((a, b, e.name))
    busy = union_s((a, b) for a, b, _ in dev) * 1e-6
    by_key = {k: 0.0 for k in kernels}
    by_name = defaultdict(float)
    for a, b, name in dev:
        by_name[name[:100]] += (b - a) * 1e-6
        for k, pats in kernels.items():
            if any(p in name for p in pats):
                by_key[k] += (b - a) * 1e-6
    cpu.sort()
    starts = [c[0] for c in cpu]
    for v in spans.values():
        v.sort()
    span_starts = {n: [a for a, _ in v] for n, v in spans.items()}
    idle = defaultdict(float)
    for g0, g1 in gaps((a, b) for a, b, _ in dev):
        # what the host was doing, sampled every 0.5 ms of the gap (its
        # middle, if shorter)
        n = max(1, int((g1 - g0) / 500))
        for k in range(n):
            t = g0 + (k + 0.5) * (g1 - g0) / n
            inner = None
            for name, v in spans.items():   # one name's spans don't overlap
                i = bisect.bisect_right(span_starts[name], t) - 1
                if i >= 0 and v[i][1] >= t and (
                        inner is None
                        or v[i][1] - v[i][0] < inner[1] - inner[0]):
                    inner = (*v[i], name)
            if inner is None:
                i = bisect.bisect_right(starts, t)
                for a, b, name in cpu[max(0, i - 256): i]:
                    if b >= t and (inner is None
                                   or b - a < inner[1] - inner[0]):
                        inner = (a, b, name)
            idle[inner[2] if inner else "(python)"] += (g1 - g0) * 1e-6 / n
    top = lambda d: [[k, v] for k, v in sorted(  # noqa: E731
        d.items(), key=lambda kv: -kv[1])[:10]]
    return busy, by_key, top(by_name), top(idle)


def cell_metrics(manifest: dict, cell: str, trace: bool) -> list:
    """The metrics a cell reports: its end-to-end ones, or the per-layer
    ones that list it (or, listing no cells, move a metric it reports)."""
    e2e = [m for m in manifest["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def load_reader(root: Path, name: str):
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}",
        root / "portbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def writer_for(cfg: dict):
    """The configuration's package writer: ``write_package`` of
    ``portbench/writers/<cfg["writer"]>.py``, else of writer.py."""
    if "writer" not in cfg:
        from portbench.writer import write_package
        return write_package
    return importlib.import_module(
        f"portbench.writers.{cfg['writer']}").write_package


def reference_module(cfg: dict):
    return importlib.import_module(
        f"portbench.references.{cfg['reference']}")


def model_work_for(cfg: dict):
    """The model's multiply-adds a valid frame, as a function of the
    configuration: the reference module's ``model_macs_per_frame``, else
    work.py's (an LCRC system's)."""
    from portbench import work
    return getattr(reference_module(cfg), "model_macs_per_frame",
                   work.model_macs_per_frame)


def setup_cell(root: Path, manifest: dict, name: str, seed: int, device,
               tmp: str, spans: Spans):
    """The cell's configuration and limits, the package written from the
    seed, the driver with the program loaded on ``device`` and the inputs
    made, and the set-up's (step, clock) marks."""
    import numpy as np
    import torch

    from portbench.traffic import driver_for
    from portbench.writer import seed64
    cell = next(w for w in manifest["workloads"] if w["name"] == name)
    entry = next(c for c in manifest["configs"]
                 if c["name"] == cell["config"])
    cfg = json.loads((root / entry["file"]).read_text())
    mix = json.loads((root / "portbench" / "mixes"
                      / f"{cell['traffic']}.json").read_text())
    driver_cls = driver_for(mix["kind"])
    write_package = writer_for(cfg)
    limits = json.loads((root / "portbench" / "limits"
                         / f"{name}.json").read_text())
    gen = torch.Generator(device=device)
    gen.manual_seed(seed64(seed))
    rng = np.random.default_rng(seed64(seed))
    marks = [("start", time.perf_counter())]
    pkg = write_package(os.path.join(tmp, "pkg"), cfg, gen, device,
                        mix.get("package_settings"))
    marks.append(("package", time.perf_counter()))
    from phnrec_tpu_torch import precision
    from phnrec_tpu_torch.pipeline import SpeechRec
    precision.set_mode(cfg["precision"])
    sr = SpeechRec(pkg, device=device)
    marks.append(("program_load", time.perf_counter()))
    driver = driver_cls(sr, cfg, mix, gen, rng, tmp, device, spans)
    marks.append(("inputs", time.perf_counter()))
    return cfg, limits, pkg, driver, marks


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             device) -> dict:
    """One run of a cell on ``device``: the result line's object."""
    import numpy as np
    import torch

    from portbench.work import PEAK_FP32
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    hooks = load_hooks(root)
    kernels = load_kernels(root)
    cuda = device.type == "cuda"
    spans = Spans(trace)
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        cfg, limits, pkg, driver, marks = setup_cell(
            root, manifest, name, seed, device, tmp, spans)
        driver.warmup()
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        gc.collect()
        setup_s = time.perf_counter() - T0
        marks = [("torch_and_card", marks[0][1] - T0)] + [
            (n, t - marks[i][1]) for i, (n, t) in enumerate(marks[1:])] + [
            ("warmup", T0 + setup_s - marks[-1][1])]
        launches, prof, undo = defaultdict(list), None, []
        if trace:
            from torch.profiler import ProfilerActivity, profile
            undo = install_hooks(hooks, spans, launches)
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                             if cuda else [])
            prof = profile(activities=acts)
            prof.start()
        try:
            out = driver.window(seconds)
            if cuda:
                torch.cuda.synchronize(device)
        finally:
            if prof is not None:
                prof.stop()
            for mod, attr, fn in undo:
                setattr(mod, attr, fn)
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        driver.drain()
        driver.sr = None
        driver.free()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        ref_mod = reference_module(cfg)
        verdict = driver.judge(ref_mod.Reference(cfg, pkg, device),
                               ref_mod.judge)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    checks = {k: [verdict[k], v] for k, v in limits.items()}
    print("readings " + " ".join(f"{k} {v!r}" for k, v in verdict.items()
                                 if k.endswith("_nats")), file=sys.stderr)
    result_device = dict(
        platform="gpu" if cuda else "cpu",
        kind=torch.cuda.get_device_name(device) if cuda else "cpu",
        count=1, memory_peak_bytes=int(peak))
    metrics = {}
    wanted = cell_metrics(manifest, name, trace)
    values = dict(out["metrics"], setup_s=setup_s)
    breakdown = None
    if trace:
        busy, by_key, top_ops, idle = (
            read_profile(prof, kernels, gap_names(hooks, spans)) if cuda
            else (0.0, dict.fromkeys(kernels, 0.0), [], []))
        result_device.update(busy_s=busy, window_s=out["wall_s"])
        t = Trace(window_s=out["wall_s"], busy_s=busy, kernel_s=by_key,
                  launches=dict(launches), spans=dict(spans.seconds),
                  item_s=out["item_s"], valid_frames=out["valid_frames"],
                  cfg=cfg,
                  model_flops=2.0 * out["valid_frames"]
                  * model_work_for(cfg)(cfg), peak_fp32=PEAK_FP32,
                  on_device=cuda,
                  extra={k: v for k, v in out.items()
                         if k not in WINDOW_KEYS})
        values = {m["name"]: load_reader(root, m["name"])(t)
                  for m in wanted}
        breakdown = dict(device_ops=top_ops, idle_gaps=idle)
    for m in wanted:
        v = values.get(m["name"])
        if v is not None:
            metrics[m["name"]] = dict(value=v, unit=m["unit"])
    print("setup " + " ".join(f"{n} {v:.3f}" for n, v in marks),
          file=sys.stderr)
    items = out["item_s"]
    print(f"window {len(items)} items, seconds at 0/25/50/75/95/100%: "
          + " ".join(f"{v:.4f}" for v in np.percentile(
              items, [0, 25, 50, 75, 95, 100])), file=sys.stderr)
    result = dict(correct=all(v <= lim for v, lim in checks.values()),
                  attempted=out["attempted"], failed=out["failed"],
                  metrics=metrics, device=result_device)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    # every build and kernel cache inside the checkout, at fixed paths
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(root / "build" / "torch_extensions"))
    # the program runs with its own threads and collector, as a user's
    # process does
    import torch
    need = cells[args.workload]["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        print(f"needs {need} CUDA device(s); found {have}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = run_cell(root, args.workload, args.seed, args.seconds,
                      bool(args.trace), device)
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"loaded in the measuring process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for k, (v, lim) in result["checks"].items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
