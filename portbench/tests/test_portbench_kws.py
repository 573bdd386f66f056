"""The ``kws`` cell's files: found from the manifest, a tiny ``kws``
cell run through ``run_cell`` on the CPU, the new modules' imports and
kernels B's and F's work arithmetic."""

import json
import subprocess
import sys

import pytest
import torch

from kwscells import (KWS_CELL, KWS_LIKE, KWS_PROBES, KWS_READERS, ROOT,
                      kws_root)
from portbench import run as R
from portbench import traffic, work


def test_manifest_finds_every_file_the_kws_cell_names():
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in m["workloads"] if w["name"] == KWS_LIKE)
    conf = next(c for c in m["configs"] if c["name"] == cell["config"])
    cfg = json.loads((ROOT / conf["file"]).read_text())
    assert (ROOT / "portbench" / "references"
            / f"{cfg['reference']}.py").is_file()
    assert callable(R.writer_for(cfg))
    mix = json.loads((ROOT / "portbench" / "mixes"
                      / f"{cell['traffic']}.json").read_text())
    assert callable(traffic.driver_for(mix["kind"]))
    assert (ROOT / "portbench" / "limits" / f"{KWS_LIKE}.json").is_file()
    traced = R.cell_metrics(m, KWS_LIKE, True)
    assert traced
    for e in m["per_layer"]:
        if KWS_LIKE in e.get("workloads", []):
            assert (ROOT / "portbench" / "metrics"
                    / f"{e['name']}.py").is_file()


@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_kws_cell_runs_on_the_cpu(tmp_path, trace):
    """The ``kws`` kind at the EN widths, 4 streams, blocks of 32: judged
    correct; traced, the launches of kernels B (717 states) and F (40
    keywords) are recorded and every new reader reads them."""
    root = kws_root(tmp_path)
    res = R.run_cell(root, KWS_CELL, 2 ** 33 + 29, 0.5, trace,
                     torch.device("cpu"))
    assert res["correct"] is True, res["checks"]
    assert set(res["checks"]) == {"lr_err_nats", "start_gap_nats",
                                  "missed_hits", "extra_hits"}
    got = {k: v["value"] for k, v in res["metrics"].items()}
    if not trace:
        assert set(got) == {"serve_audio_s_per_s", "setup_s"}
        return
    assert got["kws_b_states.tiny"] == 717
    assert got["kws_f_keywords.tiny"] == 40
    assert got["kws_readers.tiny"] == len(KWS_READERS)
    # on the CPU the device's readers read nothing; the spans' and the
    # host clock's do
    assert set(got) == set(KWS_PROBES) | {
        "hit_sync_ms.kws", "gc_share.kws", "dispatch_host_ms.kws",
        "round_p95_ms.kws"}


def test_kws_modules_import_nothing_of_the_port():
    code = ("import sys; import portbench.references.stkint_kws, "
            "portbench.writers.stkint_kws, portbench.drivers.kws, "
            "portbench.kws_work; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    top = set(eval(out))
    assert not top & {"phnrec_tpu_torch", "phnrec_tpu", "jax", "jaxlib",
                      "flax"}


def test_kws_work_gives_the_kernel_tables_bounds():
    """Kernels B and F on the EN KWS net of chip_smoke.py's checks (a
    40-phoneme loop and keywords of 5 and 3 phonemes), n 256 x F 512 on
    its ragged rows: the kernel table's bounds, 0.0137 and 0.0026 ms."""
    from types import SimpleNamespace

    from phnrec_tpu_torch.devtools.netstep_variants import inputs
    from portbench import kws_work
    cfg = dict(n_phonemes=40, n_states=3, keyword_lengths=[5, 3],
               keywords_per_length=1)
    M, E, S, nnz = kws_work.network_counts(cfg)
    assert (M, E, S) == (48, 144, 4)
    dense = SimpleNamespace(E=E, init_carry=lambda n, dev: None)
    rows = int(inputs(dense, "cpu", 256, 512, seed=21)[2].sum())
    b = work.bound_s(*kws_work.netstep_work(rows, 512, 256, E, M, S, nnz))
    f = work.bound_s(*kws_work.lrtrace_work(rows, 512, 256, 2))
    assert round(b * 1e3, 4) == 0.0137 and round(f * 1e3, 4) == 0.0026
