"""A tiny cell of the ``kws`` kind at the EN configuration's widths,
added to a copy of the benchmark by data files and manifest entries
alone."""

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# three probe readers (files of the test only) show the launches kernels B
# and F were handed and every new reader reading them with a second of
# device time a kernel
KWS_CELL = "en_timit_lcrc_n500.tiny_kws"
KWS_LIKE = "en_timit_lcrc_n500.kws1024"
TINY_KWS = dict(kind="kws", streams=4, block_frames=32, session_rounds=6,
                roll_samples=16001, warmup_rounds=2, check_streams=2)
KWS_READERS = ("netstep_roofline.kws", "lrtrace_roofline.kws",
               "mlp_roofline.kws", "hit_sync_ms.kws",
               "device_idle_share.kws", "mfu.kws")
KWS_PROBES = {
    "kws_b_states.tiny":
        "def read(t):\n"
        "    calls = t.launches.get('B')\n"
        "    return calls[0].shapes[0][2] if calls else None\n",
    "kws_f_keywords.tiny":
        "def read(t):\n"
        "    calls = t.launches.get('F')\n"
        "    return calls[0].shapes[2][0] if calls else None\n",
    "kws_readers.tiny": f'''\
import copy
from pathlib import Path

from portbench import run as R


def read(t):
    if not (t.launches.get("A") and t.launches.get("B")
            and t.launches.get("F")):
        return None
    u = copy.copy(t)
    u.kernel_s = dict(t.kernel_s, A=1.0, B=1.0, F=1.0)
    u.on_device, u.busy_s = True, t.window_s / 2
    root = Path(__file__).resolve().parents[2]
    vals = [R.load_reader(root, n)(u) for n in {KWS_READERS!r}]
    return sum(v is not None and 0 < v < 100 for v in vals)
''',
}


def kws_root(tmp: Path) -> Path:
    """A checkout-like root: BENCHMARK.json and portbench/ copied, plus
    the tiny ``kws`` cell and its probe readers."""
    shutil.copytree(ROOT / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    base = tmp / "portbench"
    (base / "mixes" / "tiny_kws.json").write_text(json.dumps(TINY_KWS))
    shutil.copy(base / "limits" / f"{KWS_LIKE}.json",
                base / "limits" / f"{KWS_CELL}.json")
    for name, text in KWS_PROBES.items():
        (base / "metrics" / f"{name}.py").write_text(text)
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    m["workloads"].append(dict(name=KWS_CELL, config="en_timit_lcrc_n500",
                               traffic="tiny_kws", chips=1, why="tiny"))
    for e in m["end_to_end"] + m["per_layer"]:
        if KWS_LIKE in e.get("workloads", []):
            e["workloads"].append(KWS_CELL)
    m["per_layer"] += [dict(name=n, unit="1", better="higher",
                            source="program_counter", layer="KWS probe",
                            moves="serve_audio_s_per_s",
                            workloads=[KWS_CELL]) for n in KWS_PROBES]
    (tmp / "BENCHMARK.json").write_text(json.dumps(m, indent=1))
    return tmp
