"""The harness: its manifest and files found by name, the lookups'
defaults, a cell of a new kind added as files alone, clashes between
files, a dry run of each kind of cell on the CPU, the no-JAX check, the
reference's imports and the work arithmetic."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from tinycells import (ECHO_CELL, ECHO_FILES, ECHO_METRICS, ECHO_WORK, ROOT,
                       TINY_MIXES, echo_root, tiny_root)
from portbench import run as R
from portbench import traffic, work, writer
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
        assert callable(traffic.driver_for(mix["kind"]))
        assert (ROOT / "portbench" / "limits" / f"{w['name']}.json").is_file()
        assert R.cell_metrics(m, w["name"], False)
        for metric in R.cell_metrics(m, w["name"], True):
            assert callable(R.load_reader(ROOT, metric["name"]))
    reported = {e["name"] for e in m["end_to_end"]}
    assert "setup_s" in reported
    for p in m["per_layer"]:
        assert p["moves"] in reported
    with pytest.raises(LookupError):
        traffic.driver_for("no_such_kind")


def test_hooks_name_functions_of_the_program():
    hooks = R.load_hooks(ROOT)
    targets = [t for ts in hooks["spans"].values() for t in ts] + [
        t for section in ("mlp_launches", "launches")
        for t in hooks.get(section, {}).values()]
    for target in targets:
        mod, attr = R._resolve(target)
        assert callable(getattr(mod, attr))


def test_the_defaults_are_todays_objects(tmp_path):
    """In a checkout with no file beside the benchmark's own, every
    lookup by name takes today's object."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(
                        "__pycache__", "tests", "hooks", "kernels"))
    assert traffic.driver_for("archive") is traffic.Archive
    assert traffic.driver_for("live") is traffic.Live
    cz = json.loads((ROOT / "portbench" / "configs"
                     / "cz_lcrc_n1500.json").read_text())
    assert R.writer_for(cz) is writer.write_package
    assert R.model_work_for(cz) is work.model_macs_per_frame
    base = tmp_path / "portbench"
    assert R.load_hooks(tmp_path) == json.loads(
        (base / "hooks.json").read_text())
    assert R.load_kernels(tmp_path) == json.loads(
        (base / "kernels.json").read_text())


def test_launch_records_and_their_undo():
    """Kernel A's record and the general one, on one function wrapped
    twice; undone, the program's own function is back."""
    from collections import defaultdict

    from phnrec_tpu_torch.ops import mlp_fused
    own = mlp_fused.mlp_forward
    target = "phnrec_tpu_torch.ops.mlp_fused:mlp_forward"
    launches = defaultdict(list)
    undo = R.install_hooks({"spans": {}, "mlp_launches": {"A": target},
                            "launches": {"any": target}},
                           R.Spans(False), launches)
    try:
        g = torch.Generator().manual_seed(0)
        x, mean, dev, w1, b1, w2, b2 = (
            torch.randn(s, generator=g)
            for s in ((2, 3), (3,), (3,), (3, 4), (4,), (4, 5), (5,)))
        mlp_fused.mlp_forward(x, mean, dev, w1, b1, w2, b2, fast=False)
    finally:
        for mod, attr, fn in undo:
            setattr(mod, attr, fn)
    assert mlp_fused.mlp_forward is own
    assert launches["A"] == [(2, 3, 4, 5)]
    assert launches["any"] == [R.Launch(
        ((2, 3), (3,), (3,), (3, 4), (4,), (4, 5), (5,)), (),
        {"fast": False})]


def _files(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in (root / "portbench").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts
            and "tests" not in p.parts}


def _grown(old, new):
    """Whether ``new`` is ``old`` with entries added: appended to each
    list, and keys of a dict unchanged but for lists that grew."""
    if isinstance(old, list):
        return isinstance(new, list) and len(new) >= len(old) and all(
            _grown(a, b) for a, b in zip(old, new))
    if isinstance(old, dict):
        return isinstance(new, dict) and set(new) == set(old) and all(
            _grown(old[k], new[k]) for k in old)
    return old == new


def test_a_cell_of_a_new_kind_is_added_as_files_alone(tmp_path):
    """The ``tiny_echo`` cell runs from a copy of the benchmark that only
    adds files and manifest entries, untraced and traced, in a process
    whose harness is the copy's; each lookup takes the new file."""
    root = echo_root(tmp_path)
    have, got = _files(ROOT), _files(root)
    assert all(got.get(k) == v for k, v in have.items())
    assert set(got) - set(have) == {f"portbench/{r}" for r in ECHO_FILES} \
        | {"portbench/configs/tiny_echo.json",
           "portbench/mixes/tiny_echo.json",
           f"portbench/limits/{ECHO_CELL}.json"}
    assert _grown(json.loads((ROOT / "BENCHMARK.json").read_text()),
                  json.loads((root / "BENCHMARK.json").read_text()))
    code = (
        "import json, torch\n"
        "from pathlib import Path\n"
        "from portbench import run as R\n"
        "torch.set_num_threads(1)\n"
        "print(json.dumps([R.__file__] + [R.run_cell(Path.cwd(), "
        f"{ECHO_CELL!r}, 2 ** 33 + 19, 0.5, trace, torch.device('cpu')) "
        "for trace in (False, True)]))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    harness, plain, traced = json.loads(out.stdout.strip().splitlines()[-1])
    assert harness == str(root / "portbench" / "run.py")
    for res in (plain, traced):
        assert res["correct"] is True, res["checks"]
    assert set(plain["metrics"]) == {"archive_audio_s_per_s", "setup_s"}
    got = {k: v["value"] for k, v in traced["metrics"].items()}
    assert set(got) == set(ECHO_METRICS)
    # the driver's own figure, the writer's key, the launches' rows, the
    # kernel key and the reference's work
    assert got["echo_passes.tiny"] >= 1
    assert got["echo_writer.tiny"] == 1
    assert got["echo_rows.tiny"] > 0
    assert got["echo_kernels.tiny"] == 1
    assert got["echo_work.tiny"] == ECHO_WORK


def _clash(root, case):
    base = root / "portbench"
    if case == "kernel":
        (base / "kernels").mkdir(exist_ok=True)
        (base / "kernels" / "clash.json").write_text('{"A": ["x"]}')
        return ["portbench/kernels.json", "portbench/kernels/clash.json"]
    if case == "launch":
        (base / "hooks").mkdir(exist_ok=True)
        (base / "hooks" / "clash.json").write_text(json.dumps({"launches": {
            "A": "phnrec_tpu_torch.ops.mlp_fused:mlp_forward"}}))
        return ["portbench/hooks.json", "portbench/hooks/clash.json"]
    mix = base / "mixes" / "tiny_archive.json"
    mix.write_text(json.dumps(dict(json.loads(mix.read_text()),
                                   kind="no_such_kind")))
    return ["portbench.traffic.DRIVERS", "portbench/drivers/no_such_kind.py"]


@pytest.mark.parametrize("case", ["kernel", "launch", "kind"])
def test_clashes_fail_at_setup_naming_the_files(tmp_path, case):
    root = tiny_root(tmp_path)
    names = _clash(root, case)
    with pytest.raises((ValueError, LookupError)) as err:
        R.run_cell(root, "cz_lcrc_n1500.tiny_archive", 2 ** 33 + 23, 0.5,
                   False, torch.device("cpu"))
    assert all(n in str(err.value) for n in names), str(err.value)


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
