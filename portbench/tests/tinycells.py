"""Tiny cells of each traffic kind, added to a copy of the benchmark by
data files and manifest entries alone."""

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# the live cells' online mean norm
ONLINE_NORM = {"onlinenorm": {"mean_norm": "true", "estim_interval": 100}}
# tiny mixes of each kind: a dummy cell is data files alone
TINY_MIXES = {
    "tiny_archive": dict(kind="archive", n_files=12, median_s=1.5,
                         sigma=0.8, min_s=0.5, max_s=4.0,
                         chunk_samples=200000, check_files=4),
    "tiny_live": dict(kind="live", streams=4, block_frames=64,
                      commit_horizon=32, session_rounds=6,
                      roll_samples=8001, warmup_rounds=4, check_streams=2,
                      package_settings=ONLINE_NORM),
}
# the smallest mixes on which the control shows what it shows at the
# cells' sizes: its TF32 products move its paths off the best and its
# label scores off the reference's, on long files (archive) and over a
# long session (live)
CONTROL_MIXES = {
    "control_archive": dict(kind="archive", n_files=8, median_s=20.0,
                            sigma=0.3, min_s=10.0, max_s=30.0,
                            chunk_samples=2000000, check_files=8),
    "control_live": dict(kind="live", streams=2, block_frames=512,
                         commit_horizon=256, session_rounds=30,
                         roll_samples=8001, warmup_rounds=4,
                         check_streams=2, package_settings=ONLINE_NORM),
}
# the committed cell whose limits and metrics each small cell takes
LIKE = {"tiny_archive": "cz_lcrc_n1500.archive",
        "tiny_live": "cz_lcrc_n1500.live1024",
        "control_archive": "cz_lcrc_n1500.archive",
        "control_live": "cz_lcrc_n1500.live1024"}


def tiny_root(tmp: Path) -> Path:
    """A checkout-like root: BENCHMARK.json and portbench/ copied, plus
    the small cells above added by data files and manifest entries
    only."""
    shutil.copytree(ROOT / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    for mix, params in {**TINY_MIXES, **CONTROL_MIXES}.items():
        (tmp / "portbench" / "mixes" / f"{mix}.json").write_text(
            json.dumps(params))
        like = LIKE[mix]
        name = f"cz_lcrc_n1500.{mix}"
        shutil.copy(tmp / "portbench" / "limits" / f"{like}.json",
                    tmp / "portbench" / "limits" / f"{name}.json")
        m["workloads"].append(dict(name=name, config="cz_lcrc_n1500",
                                   traffic=mix, chips=1, why="tiny"))
        for e in m["end_to_end"] + m["per_layer"]:
            if like in e.get("workloads", []):
                e["workloads"].append(name)
    (tmp / "BENCHMARK.json").write_text(json.dumps(m, indent=1))
    return tmp


# a cell of a made-up kind, ``tiny_echo``, added as new files and
# manifest entries alone: each file takes one of the harness's lookups by
# name, and one per-layer metric shows that it was taken
ECHO_CELL = "tiny_echo.echo"
ECHO_WORK = 1234567           # the echo reference's multiply-adds a frame
ECHO_FILES = {
    "drivers/tiny_echo.py": '''\
"""The archive driver, which also returns its passes and the label
suffix of the package it serves."""

from portbench.traffic import Archive


class Driver(Archive):
    def __init__(self, sr, *a):
        super().__init__(sr, *a)
        self.suffix = sr.cfg.get_str("labels", "suffix")

    def window(self, seconds):
        out = super().window(seconds)
        return dict(out, echo_passes=len(out["item_s"]),
                    echo_suffix=self.suffix)
''',
    "writers/tiny_echo.py": '''\
"""writer.py's package with one more config key."""

from portbench import writer


def write_package(root, cfg, gen, device, settings=None):
    return writer.write_package(root, cfg, gen, device,
                                dict(settings or {}, labels={"suffix": "echo"}))
''',
    "references/tiny_echo.py": f'''\
"""lcrc_phnloop's reference, with a model work of its own."""

from portbench.references import lcrc_phnloop
from portbench.references.lcrc_phnloop import judge  # noqa: F401


class Reference(lcrc_phnloop.Reference):
    pass


def model_macs_per_frame(cfg):
    return {ECHO_WORK}
''',
    "hooks/tiny_echo.json": json.dumps({"launches": {
        "echo_mlp": "phnrec_tpu_torch.ops.mlp_fused:mlp_forward"}}),
    "kernels/tiny_echo.json": json.dumps({"echo_kernel": ["echo_kernel"]}),
    "metrics/echo_passes.tiny.py":
        "def read(t):\n    return t.extra.get('echo_passes')\n",
    "metrics/echo_writer.tiny.py":
        "def read(t):\n"
        "    return 1 if t.extra.get('echo_suffix') == 'echo' else None\n",
    "metrics/echo_rows.tiny.py":
        "def read(t):\n"
        "    calls = t.launches.get('echo_mlp')\n"
        "    if not calls or calls[0].named != dict(fast=True,\n"
        "                                           apply_softmax=True):\n"
        "        return None\n"
        "    return sum(c.shapes[0][0] for c in calls)\n",
    "metrics/echo_kernels.tiny.py":
        "def read(t):\n"
        "    return 1 if 'echo_kernel' in t.kernel_s else None\n",
    "metrics/echo_work.tiny.py":
        "def read(t):\n"
        "    return t.model_flops / (2.0 * t.valid_frames)\n",
}
ECHO_METRICS = ("echo_passes.tiny", "echo_writer.tiny", "echo_rows.tiny",
                "echo_kernels.tiny", "echo_work.tiny")


def echo_root(tmp: Path) -> Path:
    """A checkout-like root: BENCHMARK.json and portbench/ copied, plus the
    ``tiny_echo`` cell: a driver, a writer, a reference, a configuration,
    a mix, limits, a hooks file, a kernels file and metric readers, all
    new files, and manifest entries."""
    shutil.copytree(ROOT / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    base = tmp / "portbench"
    for rel, text in ECHO_FILES.items():
        (base / rel).parent.mkdir(exist_ok=True)
        (base / rel).write_text(text)
    cfg = json.loads((base / "configs" / "cz_lcrc_n1500.json").read_text())
    cfg.update(name="tiny_echo", reference="tiny_echo", writer="tiny_echo")
    (base / "configs" / "tiny_echo.json").write_text(json.dumps(cfg))
    (base / "mixes" / "tiny_echo.json").write_text(json.dumps(
        dict(TINY_MIXES["tiny_archive"], kind="tiny_echo")))
    shutil.copy(base / "limits" / "cz_lcrc_n1500.archive.json",
                base / "limits" / f"{ECHO_CELL}.json")
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    m["configs"].append(dict(
        name="tiny_echo", source="https://example.org/tiny-echo",
        file="portbench/configs/tiny_echo.json", reduced=[], why="tiny"))
    m["workloads"].append(dict(name=ECHO_CELL, config="tiny_echo",
                               traffic="tiny_echo", chips=1, why="tiny"))
    for e in m["end_to_end"]:
        if "cz_lcrc_n1500.archive" in e.get("workloads", []):
            e["workloads"].append(ECHO_CELL)
    m["per_layer"] += [dict(name=n, unit="1", better="higher",
                            source="program_counter", layer="Echo",
                            moves="archive_audio_s_per_s",
                            workloads=[ECHO_CELL]) for n in ECHO_METRICS]
    (tmp / "BENCHMARK.json").write_text(json.dumps(m, indent=1))
    return tmp
