"""The harness: its manifest and files found by name, a dry run of each
kind of cell on the CPU, the no-JAX check, the reference's imports and
the work arithmetic."""

import json
import subprocess
import sys

import pytest
import torch

from tinycells import ROOT, TINY_MIXES, tiny_root
from portbench import run as R
from portbench.work import model_macs_per_frame, nets_macs_per_frame

RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}
MANIFEST_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
                 "end_to_end", "per_layer"}


def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_manifest_and_every_file_a_cell_names_are_found():
    m = manifest()
    assert set(m) == MANIFEST_KEYS
    names = {c["name"]: c for c in m["configs"]}
    for w in m["workloads"]:
        cfg = json.loads((ROOT / names[w["config"]]["file"]).read_text())
        assert (ROOT / "portbench" / "references"
                / f"{cfg['reference']}.py").is_file()
        mix = json.loads((ROOT / "portbench" / "mixes"
                          / f"{w['traffic']}.json").read_text())
        from portbench.traffic import DRIVERS
        assert mix["kind"] in DRIVERS
        assert (ROOT / "portbench" / "limits" / f"{w['name']}.json").is_file()
        assert R.cell_metrics(m, w["name"], False)
        for metric in R.cell_metrics(m, w["name"], True):
            assert callable(R.load_reader(ROOT, metric["name"]))
    reported = {e["name"] for e in m["end_to_end"]}
    assert "setup_s" in reported
    for p in m["per_layer"]:
        assert p["moves"] in reported


def test_hooks_name_functions_of_the_program():
    hooks = json.loads((ROOT / "portbench" / "hooks.json").read_text())
    targets = [t for ts in hooks["spans"].values() for t in ts] + \
        list(hooks["mlp_launches"].values())
    for target in targets:
        mod, attr = R._resolve(target)
        assert callable(getattr(mod, attr))


@pytest.mark.parametrize("mix", sorted(TINY_MIXES))
@pytest.mark.parametrize("trace", [False, True])
def test_dry_run_of_a_cell_added_by_data_alone(tmp_path, mix, trace):
    root = tiny_root(tmp_path)
    res = R.run_cell(root, f"cz_lcrc_n1500.{mix}", 2 ** 33 + 7, 0.5, trace,
                     torch.device("cpu"))
    assert RESULT_KEYS <= set(res)
    assert list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    m = json.loads((root / "BENCHMARK.json").read_text())
    want = {x["name"] for x in R.cell_metrics(m, f"cz_lcrc_n1500.{mix}",
                                              trace)}
    # the device figures (roofline, idle share, mfu) read nothing on the
    # CPU and are left out; the host's span and clock figures are there
    assert set(res["metrics"]) <= want
    assert res["metrics"]
    if not trace:
        assert set(res["metrics"]) == want
        assert all(v["value"] > 0 for v in res["metrics"].values())
    else:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("modules,found", [
    (["phnrec_tpu_torch", "phnrec_tpu_torch.ops.mlp_fused", "numpy"], []),
    (["phnrec_tpu.ops.pallas_mlp"], ["phnrec_tpu"]),
    (["phnrec_tpu"], ["phnrec_tpu"]),
    (["jax._src.core", "jaxlib", "flax.linen"], ["flax", "jax", "jaxlib"]),
    (["jaxtyping", "flaxen", "phnrec_tpu_torchx"], []),
])
def test_no_jax_check_compares_top_level_names_whole(modules, found):
    assert R.forbidden_modules(modules) == found


def test_reference_and_writer_import_nothing_of_the_port():
    code = ("import sys; import portbench.references.lcrc_phnloop, "
            "portbench.writer, portbench.work; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    top = set(eval(out))
    assert not top & {"phnrec_tpu_torch", "phnrec_tpu", "jax", "jaxlib",
                      "flax"}


def test_work_matches_hand_counts():
    cz = json.loads((ROOT / "portbench" / "configs"
                     / "cz_lcrc_n1500.json").read_text())
    # 165*1500 + 1500*138 twice, 276*1500 + 1500*138
    assert nets_macs_per_frame(cz) == 1_530_000
    en = dict(cz, nbanks=23, vector_size=400, band_hidden=500,
              merger_hidden=500, n_phonemes=39, n_classes=40)
    # 253*500 + 500*120 twice, 240*500 + 500*120
    assert nets_macs_per_frame(en) == 553_000
    # DFT 200 x 256, mel 128 x 15, LCRC 2 x 15 x 16 x 11
    assert model_macs_per_frame(cz) == 1_530_000 + 51_200 + 1_920 + 5_280
