"""The port's span recorder (utils/profiling.py) and the spans and
counters inside the program: off, the list path and a serving session
record nothing and open no range; inside a torch.profiler capture the
list path's spans nest under ``list`` with its batches' request ids and
appear as ranges in the profiler's events, ``labels.built`` counts the
labels the MLF gets, each serving commit is one ``serve.commit`` with its
children, collections are spans ``gc``, and two captures keep their
records apart.  CPU, the tiny synthetic package."""

import gc
import sys
import threading
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from phnrec_tpu_torch import cli, synth
from phnrec_tpu_torch.multistream import (MultiStreamKWS,
                                          MultiStreamRecognizer)
from phnrec_tpu_torch.pipeline import SpeechRec
from phnrec_tpu_torch.utils import profiling
from phnrec_tpu_torch.utils.profiling import RECORDER, Recorder

BLOCK = 32
LIST_SPANS = {"list.loader_wait", "list.log", "list.launch", "list.finish",
              "fetch.wait", "labels.build"}


@pytest.fixture(scope="module")
def pkg(tmp_path_factory):
    return synth.write_lcrc_package(tmp_path_factory.mktemp("tr") / "p",
                                    "tiny", seed=3, sent_norm=False)


@pytest.fixture(scope="module")
def sr(pkg):
    return SpeechRec(pkg, device="cpu")


@pytest.fixture(scope="module")
def kws_sr(tmp_path_factory):
    return SpeechRec(synth.write_kws_package(
        tmp_path_factory.mktemp("trk") / "p", "tiny", seed=3,
        sent_norm=False), device="cpu")


@pytest.fixture
def corpus(tmp_path):
    """A list of six raw files of 0.5-2.5 s (three length buckets, so
    several batches) and the MLF to write."""
    paths = synth.write_audio_files(tmp_path, 6, (0.5, 2.5), seed=4)
    lst = tmp_path / "list.scp"
    lst.write_text("".join(p + "\n" for p in paths))
    return str(lst), str(tmp_path / "out.mlf")


@pytest.fixture(scope="module")
def audio():
    rng = np.random.default_rng(7)
    return synth.synth_audio(rng, 8000 * 3).astype("<i2").tobytes()


def _serve(sr, audio, ragged=False):
    """A session of three streams with commits: fed alike (lockstep, the
    device commit) or with one stream shorter (the host replay)."""
    ms = MultiStreamRecognizer(sr, 3, block_frames=BLOCK, commit_horizon=40)
    streams = [audio, audio[: len(audio) // 2 // 2 * 2] if ragged else audio,
               audio[3200:] if ragged else audio]
    for off in range(0, len(audio), 3000):
        for i, s in enumerate(streams):
            if off < len(s):
                ms.process(i, s[off: off + 3000])
            elif not ms._ended[i]:
                ms.end_stream(i)
    return ms.finish()


def _mlf_labels(path) -> int:
    with open(path) as f:
        return sum(1 for line in f if line[:1].isdigit())


def _ancestors(rec, by_seq):
    out = []
    while rec.parent is not None:
        rec = by_seq[rec.parent]
        out.append(rec.name)
    return out


def test_off_records_nothing_and_opens_no_range(sr, corpus, audio,
                                                monkeypatch):
    assert not RECORDER.enabled
    RECORDER.snapshot()                 # closes a capture left behind
    last = RECORDER._last
    n_last = len(last.records) if last else 0

    def no_range(*a, **k):
        raise AssertionError("a range was opened while off")
    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", no_range)
    sr.process_file_list("wf", "str", *corpus)
    assert _serve(sr, audio)[0]
    assert RECORDER._cap is None and RECORDER._last is last
    assert (len(last.records) if last else 0) == n_last
    assert RECORDER._on_gc not in gc.callbacks
    assert profiling.span("x") is profiling.span("y")   # one shared no-op


def test_list_path_spans_nest_under_list(sr, corpus):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sr.process_file_list("wf", "str", *corpus)
    snap = RECORDER.snapshot()
    assert RECORDER._on_gc not in gc.callbacks
    recs = [r for r in snap.records if r.name != "gc"]
    by_seq = {r.seq: r for r in snap.records}
    (top,) = [r for r in recs if r.name == "list"]
    call = top.id[0]
    assert top.id == (call, None) and top.parent is None
    assert {r.name for r in recs} == LIST_SPANS | {"list", "list.mlf"}
    batches = {}
    for r in recs:
        if r.name == "list":
            continue
        assert _ancestors(r, by_seq)[-1] == "list"
        assert top.start_ns <= r.start_ns <= r.end_ns <= top.end_ns
        assert r.id[0] == call
        if r.name != "list.mlf":
            batches.setdefault(r.id, set()).add(r.name)
    # every batch of this call: each span of the list path once, one id;
    # then the wait that finds the loader done
    assert sorted(batches) == [(call, k) for k in range(len(batches))]
    *full, (_, end) = sorted(batches.items())
    assert len(full) >= 2 and end == {"list.loader_wait"}
    assert all(names == LIST_SPANS for _, names in full)
    assert snap.counters["loader.batches"] == len(full)
    assert snap.counters["loader.files"] == 6
    assert snap.counters["loader.read_s"] > 0
    # self time: the duration less the children's
    child = Counter()
    for r in snap.records:
        if r.parent is not None:
            child[r.parent] += r.end_ns - r.start_ns
    assert all(r.self_ns == r.end_ns - r.start_ns - child[r.seq]
               for r in snap.records)
    st = snap.spans["list"]
    assert st.count == 1 and 0 < st.self_s < st.total_s
    # the spans are ranges of the profiler's trace, each as many times
    ranges = Counter(e.name for e in prof.events())
    for name, st in snap.spans.items():
        assert ranges[name] == st.count


def test_labels_built_counts_the_labels_the_mlf_gets(sr, corpus):
    with profile(activities=[ProfilerActivity.CPU]):
        sr.process_file_list("wf", "str", *corpus)
    snap = RECORDER.snapshot()
    assert snap.counters["labels.built"] == _mlf_labels(corpus[1]) > 0
    assert snap.spans["labels.build"].count == \
        snap.counters["loader.batches"]


@pytest.mark.parametrize("ragged", [False, True])
def test_each_commit_is_one_serve_commit_with_its_children(sr, audio,
                                                           monkeypatch,
                                                           ragged):
    commits = []
    real = MultiStreamRecognizer._drop_and_rebase
    monkeypatch.setattr(MultiStreamRecognizer, "_drop_and_rebase",
                        lambda self: commits.append(1) or real(self))
    with profile(activities=[ProfilerActivity.CPU]):
        labels = _serve(sr, audio, ragged)
    assert all(labels)
    snap = RECORDER.snapshot()
    recs = [r for r in snap.records if r.name != "gc"]
    by_seq = {r.seq: r for r in snap.records}
    done = [r for r in recs if r.name == "serve.commit"]
    assert len(commits) >= 2
    assert len(done) == len(commits) == snap.counters["serve.commits"]
    # each commit first waits for the card; the device walk's then
    # fetches and keeps its labels as arrays; the host replay's (streams
    # advanced unevenly) walks each stream itself
    host = ["fetch.wait", "serve.commit_streams", "serve.rebase"]
    device = sorted(host + ["fetch.wait", "labels.columns"])
    kinds = []
    for c in done:
        kids = sorted(r.name for r in recs if r.parent == c.seq)
        assert kids in (host, device)
        kinds.append(kids == host)
        assert by_seq[c.parent].name == "serve.round"
        assert c.id == by_seq[c.parent].id
    assert any(kinds) == ragged and not all(kinds)
    rounds = [r for r in recs if r.name == "serve.round"]
    server = rounds[0].id[0]
    assert [r.id for r in rounds] == [(server, k) for k in
                                      range(len(rounds))]
    (fin,) = [r for r in recs if r.name == "serve.finish"]
    assert fin.id == (server, len(rounds) - sum(
        1 for r in rounds if r.start_ns > fin.start_ns))
    # the committed labels are made into Labels at finish()
    builds = [r for r in recs if r.name == "labels.build"]
    assert builds and all("serve.finish" in _ancestors(r, by_seq)
                          for r in builds)
    assert snap.spans["serve.launch"].count >= len(rounds)


def test_kws_hit_syncs_are_spans_with_their_fetch_and_decode(kws_sr,
                                                            audio):
    """A live KWS session of three streams polled by hits_so_far after
    every feed: a poll that finds blocks to fetch is one ``kws.sync``
    holding one ``kws.fetch`` and then one ``kws.decode``, and finish()'s
    holds another pair for the final flush; the polls that find nothing
    open no span; ``kws.hits`` counts the Labels delivered."""
    ms = MultiStreamKWS(kws_sr, 3, block_frames=BLOCK)
    delivered = polls = 0
    with profile(activities=[ProfilerActivity.CPU]):
        for off in range(0, len(audio), 3000):
            for i in range(3):
                ms.process(i, audio[off: off + 3000])
            for i in range(3):
                delivered += len(ms.hits_so_far(i))
                polls += 1
        res = ms.finish()
        delivered += sum(len(ms.hits_so_far(i)) for i in range(3))
    snap = RECORDER.snapshot()
    recs = [r for r in snap.records if r.name != "gc"]
    syncs = [r for r in recs if r.name == "kws.sync"]
    assert 2 <= len(syncs) == snap.counters["kws.syncs"] < polls
    pair = ["kws.fetch", "kws.decode"]
    for k, sync in enumerate(sorted(syncs, key=lambda r: r.start_ns)):
        kids = sorted((r for r in recs if r.parent == sync.seq),
                      key=lambda r: r.start_ns)
        assert [r.name for r in kids] in (
            [pair] if k < len(syncs) - 1 else [pair, pair + pair])
    assert delivered == sum(map(len, res)) == snap.counters["kws.hits"] > 0
    assert snap.counters.get("kws.overflow_streams", 0) == 0


def test_kws_overflow_streams_counts_the_streams_off_the_rings(kws_sr):
    """Flush events past a ring's H slots (as in
    test_ring_overflow_decodes_dense_records): ``kws.overflow_streams``
    counts exactly the streams decoded from the dense records."""
    N, F, K = 4, 300, 2
    rng = np.random.default_rng(9)
    recs = []
    for r in range(2):
        emit = rng.random((N, F, K)) < (0.4, 0.05)[r]
        emit[0] = False
        emit[3] = rng.random((F, K)) < 0.02             # fits its ring
        recs.append({
            "emit": emit,
            "start": rng.integers(0, 500, (N, F, K)).astype(np.int32),
            "end": rng.integers(0, 500, (N, F, K)).astype(np.int32),
            "score": rng.normal(-30, 5, (N, F, K)).astype(np.float32),
            "new_estim": rng.random((N, F, K)) < 0.3})
    total = recs[0]["emit"].sum((1, 2)) + recs[1]["emit"].sum((1, 2))
    over = total > max(64, F // 4)
    assert over.tolist() == [False, True, True, False]
    ms = MultiStreamKWS(kws_sr, n_streams=N, block_frames=F)
    ms._hist = [(ms._compact_events(tuple(
        {k: torch.from_numpy(v) for k, v in rec.items()} for rec in recs)),
        np.full(N, F, np.int64))]
    with profile(activities=[ProfilerActivity.CPU]):
        got = ms.results()
    snap = RECORDER.snapshot()
    assert snap.counters["kws.overflow_streams"] == int(over.sum())
    assert snap.counters["kws.hits"] == sum(map(len, got)) == total.sum()
    assert snap.spans["kws.sync"].count == 1


def _lockstep(sr, audio, poll):
    """A lockstep session of three streams with commits (the device
    commit), polled by results() after every feed or not; the server and
    the labels each results() walked in the window (past the committed
    ones), finish() and a results() after it included."""
    ms = MultiStreamRecognizer(sr, 3, block_frames=BLOCK, commit_horizon=40)
    walked = 0

    def read(labels):
        nonlocal walked
        walked += sum(len(g) - len(m) for g, m in zip(labels, ms._made))
        return labels
    for off in range(0, len(audio), 3000):
        for i in range(3):
            ms.process(i, audio[off: off + 3000])
        if poll:
            read(ms.results())
    return ms, read(ms.finish()), read(ms.results()), walked


@pytest.mark.parametrize("poll", [False, True])
def test_committed_labels_are_kept_as_arrays_and_made_once(sr, audio,
                                                           monkeypatch,
                                                           poll):
    """The commits keep their labels as arrays (``labels.kept``) and make
    no Label (``labels.built`` does not move across a commit); results()
    makes each committed label once, so over the session ``labels.built``
    is the committed labels and the labels each read walked in the
    window, and a read after finish() hands back the same committed
    Labels."""
    moved = []
    real = MultiStreamRecognizer._maybe_commit

    def commit(self):
        built = lambda: RECORDER.snapshot().counters.get(  # noqa: E731
            "labels.built", 0)
        before = built()
        real(self)
        moved.append(built() - before)
    monkeypatch.setattr(MultiStreamRecognizer, "_maybe_commit", commit)
    with profile(activities=[ProfilerActivity.CPU]):
        ms, got, again, walked = _lockstep(sr, audio, poll)
    snap = RECORDER.snapshot()
    committed = sum(len(m) for m in ms._made)
    assert snap.counters["serve.commits"] >= 2
    assert moved and not any(moved)
    assert snap.counters["labels.kept"] == committed > 0
    assert snap.counters["labels.built"] == committed + walked
    for a, g, m in zip(again, got, ms._made):
        assert all(x is y for x, y in zip(a[: len(m)], g[: len(m)]))
    if not poll:
        assert snap.spans["labels.build"].count == 3    # 2 walks, 1 pass


@pytest.mark.parametrize("state", ["enabled", "disabled", "raises"])
def test_the_bulk_pass_pauses_the_collector_and_restores_it(
        sr, audio, monkeypatch, state):
    """finish()'s bulk pass makes its Labels with the collector off and
    leaves it as the caller had it: enabled stays enabled, disabled stays
    disabled, also when the pass raises."""
    from phnrec_tpu_torch import multistream
    ms = MultiStreamRecognizer(sr, 3, block_frames=BLOCK, commit_horizon=40)
    for i in range(3):
        ms.process(i, audio)
    assert ms._kept
    seen, real = [], multistream.Label

    def label(*a):
        seen.append(gc.isenabled())
        if state == "raises":
            raise RuntimeError("made no label")
        return real(*a)
    monkeypatch.setattr(multistream, "Label", label)
    was = gc.isenabled()
    try:
        (gc.disable if state == "disabled" else gc.enable)()
        if state == "raises":
            with pytest.raises(RuntimeError, match="made no label"):
                ms.finish()
        else:
            assert all(ms.finish())
        after = gc.isenabled()
    finally:
        (gc.enable if was else gc.disable)()
    assert seen and not any(seen)
    assert after == (state != "disabled")


def test_a_collection_inside_a_capture_is_a_gc_span():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("outer"):
            gc.collect()
    snap = RECORDER.snapshot()
    (g,) = [r for r in snap.records if r.name == "gc"]
    (outer,) = [r for r in snap.records if r.name == "outer"]
    assert g.parent == outer.seq
    assert outer.self_ns == outer.end_ns - outer.start_ns - (
        g.end_ns - g.start_ns)
    assert snap.counters["gc.g2"] == 1
    assert snap.counters["gc.collected"] >= 0
    assert "gc" in {e.name for e in prof.events()}


def test_two_captures_keep_their_records_apart():
    for names in (["a", "a"], ["b"]):
        with profile(activities=[ProfilerActivity.CPU]):
            for n in names:
                with profiling.span(n):
                    profiling.count("n")
        snap = RECORDER.snapshot()
        assert {k: v.count for k, v in snap.spans.items()
                if k != "gc"} == {names[0]: len(names)}
        assert snap.counters["n"] == len(names)
    # a span after a capture, with the profiler off, records nothing and
    # leaves the last capture readable
    with profiling.span("c"):
        pass
    assert "c" not in RECORDER.snapshot().spans


def test_enabled_recorder_and_its_summary():
    rec = Recorder()
    assert rec.snapshot() is None
    rec.enable()
    try:
        with rec.span("outer", id=7):
            with rec.span("inner") as s:
                rec.count("k", 2)
                rec.count("k", 3)
        assert s.id == 7
        assert rec._on_gc in gc.callbacks
    finally:
        rec.disable()
    assert rec._on_gc not in gc.callbacks
    snap = rec.snapshot()
    assert snap.counters == {"k": 5}
    assert {n: st.count for n, st in snap.spans.items()} == {"outer": 1,
                                                             "inner": 1}
    assert snap.within[("outer", "inner")].count == 1
    text = snap.summary().splitlines()
    assert text[0].split() == ["span", "count", "total_s", "self_s"]
    assert {"outer", "inner", "k"} <= {l.split()[0] for l in text}


def test_a_long_capture_keeps_its_sums_and_the_last_spans(monkeypatch):
    monkeypatch.setattr(profiling, "RECORDS_KEPT", 100)
    rec = Recorder()
    collecting = gc.isenabled()
    gc.disable()                        # no span gc among the 500
    rec.enable()
    try:
        for _ in range(250):
            with rec.span("outer"):
                with rec.span("inner"):
                    pass
    finally:
        rec.disable()
        if collecting:
            gc.enable()
    snap = rec.snapshot()
    assert snap.spans["outer"].count == snap.spans["inner"].count == 250
    assert snap.within[("outer", "inner")].count == 250
    assert snap.within[(None, "outer")].count == 250
    assert len(snap.records) == 100
    assert sorted(r.seq for r in snap.records) == list(range(400, 500))
    total = snap.spans["outer"]
    assert 0 < total.self_s < total.total_s


def test_counts_from_many_threads_are_not_lost():
    rec = Recorder()
    rec.enable()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                rec.count("n")
        threads = [threading.Thread(target=work) for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        rec.disable()
    assert rec.snapshot().counters["n"] == 32 * 2000


def test_cli_profile_prints_the_recorders_spans(pkg, corpus, capsys):
    assert cli.main(["--profile", "-c", pkg, "--device", "cpu", "-l",
                     corpus[0], "-m", corpus[1]]) == 0
    err = capsys.readouterr().err.splitlines()
    head = err.index(next(l for l in err if l.split()[:2] == ["span",
                                                              "count"]))
    rows = {l.split()[0]: l.split()[1:] for l in err[head + 1:]}
    assert {"list", "list.launch", "labels.build", "list.mlf"} <= set(rows)
    assert float(rows["labels.built"][0]) == _mlf_labels(corpus[1])
    assert not RECORDER.enabled
