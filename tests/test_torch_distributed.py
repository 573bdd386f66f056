"""The port's distributed runner and mesh paths (parallel/distributed.py,
parallel/mesh.py, BatchPipeline(mesh=), the three servers with mesh=,
psum_accumulators) on gloo process groups over a FileStore, no network.

* shard_list, bucket_by_frames, Progress: equal to phnrec_tpu's.
* DistributedRunner on a 1-rank group against phnrec_tpu's runner without
  a mesh on one synthetic package: the MLF's labels equal (scores within
  1e-3, as tests/test_torch_pipeline.py holds the batch path), the
  counters equal, a resumed run decodes 0 utterances.
* One spawned 2-rank run (``python tests/test_torch_distributed.py DIR``,
  under a subprocess timeout, each collective under the group's timeout)
  checks every sharded path against its unsharded run in the same
  process: the runner's two shards (one MLF, list order), the resume,
  aggregate_across_hosts, BatchPipeline(mesh) on an odd batch, the
  phoneme-loop server with and without commit_horizon (ragged feeding),
  the KWS server, the stkint decode server through
  decode_device_buffer(shard_audio(...)), and psum_accumulators against
  the serial sum of tests/test_train_distributed.py (relative 2e-5, as
  tests/test_torch_train.py)."""

import os
import pickle
import subprocess
import sys
from datetime import timedelta

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_STREAMS = 4
REL_ACC = 2e-5


def one_rank_mesh(tmp_path, names=("data",)):
    """A DeviceMesh over a 1-rank gloo group (initialized once a process,
    over a FileStore)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        dist.init_process_group(
            "gloo", store=dist.FileStore(str(tmp_path / "store1"), 1),
            rank=0, world_size=1, timeout=timedelta(seconds=60))
    return init_device_mesh("cpu", (1,), mesh_dim_names=names)


def _key(labels):
    return [(l.start_frames, l.end_frames, l.name) for l in labels]


def _files(root, n, seed, sizes=(6000, 30000)):
    from phnrec_tpu_torch import synth
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        f = os.path.join(root, f"u{i:02d}.raw")
        with open(f, "wb") as fh:
            fh.write(synth.synth_audio(rng, int(rng.integers(*sizes)))
                     .astype("<i2").tobytes())
        out.append(f)
    return out


def test_shard_bucket_progress_match_jax(tmp_path):
    from phnrec_tpu.parallel import distributed as J

    from phnrec_tpu_torch.parallel import distributed as P
    entries = [f"u{i}" for i in range(11)]
    for i in range(3):
        assert P.shard_list(entries, i, 3) == J.shard_list(entries, i, 3)
    lengths = np.random.default_rng(0).integers(1, 20000, 40).tolist()
    assert P.bucket_by_frames(lengths, 4, 512) == \
        J.bucket_by_frames(lengths, 4, 512)
    p = str(tmp_path / "progress.jsonl")
    pr = P.Progress.open(p)
    pr.mark("a.raw", 5)
    pr.mark("b.raw", 7)
    pr.mark("c.raw", 1, write=False)
    with open(p, "a") as f:
        f.write("not json\n")
    assert P.Progress.open(p).done == J.Progress.open(p).done == \
        {"a.raw": 5, "b.raw": 7}


def test_runner_one_rank_matches_jax(tmp_path):
    from phnrec_tpu.io.labels import read_mlf as jread_mlf
    from phnrec_tpu.parallel.distributed import DistributedRunner as JRunner
    from phnrec_tpu.pipeline import SpeechRec as JSpeechRec

    from phnrec_tpu_torch import synth
    from phnrec_tpu_torch.io.labels import read_mlf
    from phnrec_tpu_torch.parallel.distributed import (
        DistributedRunner, RunMetrics, aggregate_across_hosts)
    from phnrec_tpu_torch.pipeline import SpeechRec

    one_rank_mesh(tmp_path)
    pkg = synth.write_lcrc_package(tmp_path / "pkg", "tiny", seed=1)
    files = _files(str(tmp_path), 7, 1)
    lst = tmp_path / "l.scp"
    lst.write_text("".join(f + "\n" for f in files))
    sr = SpeechRec(pkg, device="cpu")
    prog = str(tmp_path / "prog.jsonl")
    got = DistributedRunner(sr, max_batch=3, progress_file=prog).run(
        str(lst), mlf_path=str(tmp_path / "t.mlf"))
    want = JRunner(JSpeechRec(pkg), max_batch=3).run(
        str(lst), mlf_path=str(tmp_path / "j.mlf"))
    for k in ("n_utterances", "n_frames", "n_labels"):
        assert got[k] == want[k], k
    assert got["audio_seconds"] == pytest.approx(want["audio_seconds"],
                                                 rel=1e-6)
    t, j = read_mlf(str(tmp_path / "t.mlf")), jread_mlf(str(tmp_path /
                                                          "j.mlf"))
    assert sorted(t) == sorted(j) and len(t) == len(files)
    for name in j:
        assert _key(t[name]) == _key(j[name])
        np.testing.assert_allclose([l.score for l in t[name]],
                                   [l.score for l in j[name]], atol=1e-3)
    # the MLF is in list order, as process_file_list writes it
    sr.process_file_list("wf", "str", str(lst), str(tmp_path / "s.mlf"))
    assert open(tmp_path / "t.mlf").read() == \
        open(tmp_path / "s.mlf").read()
    again = DistributedRunner(sr, max_batch=3, progress_file=prog).run(
        str(lst))
    assert again["n_utterances"] == 0
    m = RunMetrics(1.25, 7, 2, 9, 0.5)
    assert aggregate_across_hosts(m) == m.as_dict()


def test_one_rank_mesh_paths(tmp_path):
    """At world size 1 (the card's machine) the mesh paths run their
    collectives and row bookkeeping and equal the unsharded runs; a bad
    mesh raises."""
    import torch

    import phnrec_tpu_torch.train as P
    from phnrec_tpu_torch import synth
    from phnrec_tpu_torch.io.mmf import parse_mmf
    from phnrec_tpu_torch.parallel.batch import (BatchPipeline,
                                                 aggregate_metrics)
    from phnrec_tpu_torch.pipeline import SpeechRec
    from tests.test_train import MMF_GMM

    mesh = one_rank_mesh(tmp_path)
    sr = SpeechRec(synth.write_lcrc_package(tmp_path / "pkg", "tiny",
                                            seed=2), device="cpu")
    rng = np.random.default_rng(2)
    wave = np.zeros((3, 24000), np.int16)
    ns = np.array([24000, 9000, 15000], np.int32)
    for i, n in enumerate(ns):
        wave[i, :n] = synth.synth_audio(rng, int(n))
    a = BatchPipeline(sr, mesh=mesh).run_padded(wave, ns)
    b = BatchPipeline(sr).run_padded(wave, ns)
    assert a.labels == b.labels and np.array_equal(a.n_frames, b.n_frames)
    assert aggregate_metrics({"x": 1.5, "y": 2.0}, mesh) == \
        {"x": 1.5, "y": 2.0}
    for bad, err in ((object(), TypeError),
                     (one_rank_mesh(tmp_path, ("x",)), ValueError)):
        with pytest.raises(err):
            BatchPipeline(sr, mesh=bad)
        with pytest.raises(err):
            aggregate_metrics({"x": 1.0}, bad)
    (tmp_path / "m.mmf").write_text(MMF_GMM)
    tm = parse_mmf(str(tmp_path / "m.mmf"))
    g = P.compile_transcription(tm, ["a", "b"])
    acc = P.accumulate_utterance(g, P.make_accumulators(g.index, "cpu"),
                                 rng.normal(size=(8, 2)).astype(np.float32),
                                 8)
    import torch.distributed as dist
    for handle in (mesh, dist.group.WORLD):
        out = P.psum_accumulators(acc, handle)
        for x, y in zip(out, acc):
            assert (x is None and y is None) or torch.equal(x, y)
    with pytest.raises(TypeError):
        P.psum_accumulators(acc, "data")


# -- the spawned 2-rank run ---------------------------------------------------
def _servers(sr_loop, sr_kws, sr_stk, raw, mesh, audio):
    """The three servers' labels on one feeding (each stream its own
    rotation of ``raw``): the phoneme loop with ragged chunks, without and
    with commit_horizon, KWS in lockstep, and stkint decode from a device
    buffer; and, with commits, each server's (blocks this rank dropped,
    blocks every rank dropped)."""
    import torch

    from phnrec_tpu_torch.multistream import (MultiStreamKWS,
                                              MultiStreamRecognizer,
                                              MultiStreamStkDecode)
    out, drops = {}, {}

    def dropped(ms):
        return (ms._n_dropped,
                len(ms._hist) + ms._n_dropped - len(ms._g_valid))

    streams = [raw[2400 * i:] + raw[:2400 * i] for i in range(N_STREAMS)]
    for name, kw in (("loop", {}), ("loop_commit", dict(commit_horizon=24)),
                     ("loop_partial", dict(partial_pump=True,
                                           commit_horizon=24))):
        ms = MultiStreamRecognizer(sr_loop, N_STREAMS, block_frames=32,
                                   mesh=mesh, **kw)
        for off in range(0, len(raw), 2000):
            for i in range(N_STREAMS):
                # the second half of the streams (rank 1's) arrive slower
                slow = i >= N_STREAMS // 2
                step = 1000 if slow else 2000
                lo = off // 2 if slow else off
                ms.process(i, streams[i][lo: lo + step])
        drops[name] = dropped(ms)
        for i in range(N_STREAMS):
            ms.end_stream(i)
        out[name] = ms.finish()
    kws = MultiStreamKWS(sr_kws, N_STREAMS, block_frames=32, mesh=mesh)
    for off in range(0, len(raw), 3000):
        for i in range(N_STREAMS):
            kws.process(i, streams[i][off: off + 3000])
    out["kws"] = kws.finish()
    stk = MultiStreamStkDecode(sr_stk, N_STREAMS, block_frames=32,
                               mesh=mesh, record_horizon=96)
    buf = stk.shard_audio(audio) if mesh is not None else \
        torch.as_tensor(audio)
    stk.decode_device_buffer(buf, n_blocks=6)
    stk.decode_device_buffer(buf, n_blocks=4, first_block=6)
    drops["stk"] = dropped(stk)
    out["stk"] = stk.finish()
    return out, drops


def _rank_main(rank, root):
    """One rank of the 2-rank run: every sharded path and its unsharded
    run, results pickled to ROOT/out<rank>.pkl."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import phnrec_tpu_torch.train as P
    from phnrec_tpu_torch import synth
    from phnrec_tpu_torch.io.mmf import parse_mmf
    from phnrec_tpu_torch.multistream import MultiStreamRecognizer
    from phnrec_tpu_torch.parallel.batch import (BatchPipeline,
                                                 aggregate_metrics)
    from phnrec_tpu_torch.parallel.distributed import (
        DistributedRunner, RunMetrics, aggregate_across_hosts)
    from phnrec_tpu_torch.pipeline import SpeechRec

    torch.set_num_threads(2)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(root, "store2"), 2),
        rank=rank, world_size=2, timeout=timedelta(seconds=120))
    mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("data",))
    pk = lambda name: os.path.join(root, name)  # noqa: E731
    out = {}
    sr = SpeechRec(pk("loop"), device="cpu")

    # the runner: strided shards, one MLF from rank 0, then a resume
    runner = DistributedRunner(sr, max_batch=3,
                               progress_file=pk(f"prog{rank}.jsonl"))
    out["runner"] = runner.run(pk("l.scp"), mlf_path=pk("run2.mlf"))
    out["resume"] = DistributedRunner(
        sr, max_batch=3, progress_file=pk(f"prog{rank}.jsonl")).run(
        pk("l.scp"))
    # with a mesh both ranks share the list and split each batch's rows
    out["runner_mesh"] = DistributedRunner(sr, mesh=mesh, max_batch=3).run(
        pk("l.scp"), mlf_path=pk("runmesh.mlf"))
    out["agg"] = aggregate_across_hosts(
        RunMetrics(1.5 * (rank + 1), 10 * (rank + 1), rank + 1, 3,
                   float(rank + 2)))
    out["agg_metrics"] = aggregate_metrics({"a": rank + 1.0, "b": 2.0},
                                           mesh)

    # BatchPipeline(mesh) on 5 rows: rank 0 runs 3, rank 1 runs 2
    rng = np.random.default_rng(7)
    ns = np.array([24000, 9000, 15000, 20000, 5000], np.int32)
    wave = np.zeros((5, 24000), np.int16)
    for i, n in enumerate(ns):
        wave[i, :n] = synth.synth_audio(rng, int(n))
    out["batch"] = (BatchPipeline(sr, mesh=mesh).run_padded(wave, ns).labels,
                    BatchPipeline(sr).run_padded(wave, ns).labels)

    # the servers, sharded and unsharded
    srs = (sr, SpeechRec(pk("kws"), device="cpu"),
           SpeechRec(pk("stk"), device="cpu"))
    raw = open(pk("stream.raw"), "rb").read()
    audio = np.load(pk("audio.npy"))
    out["servers"] = (_servers(*srs, raw, mesh, audio),
                      _servers(*srs, raw, None, audio))
    try:
        MultiStreamRecognizer(sr, 3, mesh=mesh)
        out["divide"] = None
    except ValueError as e:
        out["divide"] = str(e)

    # psum over the mesh: rank r accumulates utterances 2r, 2r + 1
    tm = parse_mmf(pk("m.mmf"))
    g = P.compile_transcription(tm, ["a", "b"])
    xs = np.random.default_rng(0).normal(size=(4, 8, 2)).astype(np.float32)
    acc = P.make_accumulators(g.index, "cpu")
    for x in xs[2 * rank: 2 * rank + 2]:
        acc = P.accumulate_utterance(g, acc, x, 8)
    ref = P.make_accumulators(g.index, "cpu")
    for x in xs:
        ref = P.accumulate_utterance(g, ref, x, 8)
    out["psum"] = (P.psum_accumulators(acc, mesh), ref)
    with open(pk(f"out{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def test_two_rank_gloo_sharded_paths_equal_unsharded(tmp_path):
    import torch

    from phnrec_tpu_torch import synth
    from phnrec_tpu_torch.io.labels import read_mlf
    from phnrec_tpu_torch.pipeline import SpeechRec
    from tests.test_train import MMF_GMM

    root = str(tmp_path)
    synth.write_lcrc_package(tmp_path / "loop", "tiny", seed=0,
                             sent_norm=False)
    synth.write_kws_package(tmp_path / "kws", "tiny", seed=0,
                            sent_norm=False)
    synth.write_stk_decode_package(tmp_path / "stk", "tiny", seed=0,
                                   sent_norm=False)
    (tmp_path / "m.mmf").write_text(MMF_GMM)
    files = _files(root, 9, 3)
    (tmp_path / "l.scp").write_text("".join(f + "\n" for f in files))
    rng = np.random.default_rng(4)
    raw = synth.synth_audio(rng, 8000 * 4).astype("<i2").tobytes()
    (tmp_path / "stream.raw").write_bytes(raw)
    np.save(tmp_path / "audio.npy",
            np.stack([synth.synth_audio(rng, 8000 * 4).astype(np.int16)
                      for _ in range(N_STREAMS)]))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), root],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    outs = [pickle.load(open(tmp_path / f"out{r}.pkl", "rb"))
            for r in range(2)]

    # the runner: both shards in one MLF, in list order, equal to the
    # unsharded list decode; counters summed over the ranks
    sr = SpeechRec(str(tmp_path / "loop"), device="cpu")
    sr.process_file_list("wf", "str", str(tmp_path / "l.scp"),
                         str(tmp_path / "serial.mlf"))
    serial = open(tmp_path / "serial.mlf").read()
    assert open(tmp_path / "run2.mlf").read() == serial
    assert open(tmp_path / "runmesh.mlf").read() == serial
    n_labels = sum(len(v) for v in read_mlf(str(tmp_path /
                                                "serial.mlf")).values())
    for o in outs:
        for k in ("runner", "runner_mesh"):
            assert o[k]["n_utterances"] == len(files), k
            assert o[k]["n_labels"] == n_labels, k
        assert o["resume"]["n_utterances"] == 0
        assert o["agg"]["audio_seconds"] == 1.5 + 3.0
        assert o["agg"]["n_frames"] == 30 and o["agg"]["n_labels"] == 6
        assert o["agg"]["wall_seconds"] == 3.0
        assert o["agg_metrics"] == {"a": 3.0, "b": 4.0}
        sharded, whole = o["batch"]
        assert sharded == whole and len(whole) == 5
        assert o["divide"] and "divide" in o["divide"]
    # the servers: every rank returns all streams, equal to the unsharded
    # run (the same process, the same package)
    for o in outs:
        (sharded, _), (whole, _) = o["servers"]
        for name in whole:
            assert len(sharded[name]) == N_STREAMS
            assert any(whole[name]), name
            assert [_key(x) for x in sharded[name]] == \
                [_key(x) for x in whole[name]], name
            for x, y in zip(sharded[name], whole[name]):
                np.testing.assert_allclose([l.score for l in x],
                                           [l.score for l in y], rtol=0,
                                           atol=1e-4, err_msg=name)
    assert outs[0]["servers"][0][0] == outs[1]["servers"][0][0]
    # the ranks dropped History blocks by their own rows' commits, and the
    # trigger read the blocks both had dropped
    drops = [o["servers"][0][1] for o in outs]
    print("blocks dropped (this rank, every rank):", drops)
    for name in ("loop_commit", "loop_partial", "stk"):
        assert all(d[name][0] > 0 for d in drops), name
        assert drops[0][name][1] == drops[1][name][1] == \
            min(d[name][0] for d in drops), name
    # rank 1's slower streams held the blocks rank 0 had dropped
    assert drops[0]["loop_commit"][0] > drops[1]["loop_commit"][0]
    # psum: the summed accumulators equal the serial sum on both ranks
    for o in outs:
        got, ref = o["psum"]
        for name, a, b in zip(ref._fields, got, ref):
            if b is None:
                assert a is None
                continue
            err = (a - b).abs() / torch.clamp(b.abs(), min=1.0)
            assert float(err.max()) <= REL_ACC, name
        assert float(got.n_utts) == 4.0


if __name__ == "__main__":
    import torch.multiprocessing as mp
    sys.path.insert(0, REPO)
    mp.spawn(_rank_main, args=(sys.argv[1],), nprocs=2, join=True)
