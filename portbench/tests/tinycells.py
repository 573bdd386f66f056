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
