"""The benchmark's plain KWS reference (portbench/references/stkint_kws.py)
and the port's live keyword spotting: MultiStreamKWS's hits (CPU, plain
versions of kernels A, B and F) judged by the reference on a tiny LCRC
KWS package; the reference's network against the one the port's netgen
writes; the judge failing hits that are off, lost or given twice; and
the cell's keyword lengths within kernel B's dense limit."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from phnrec_tpu_torch import synth
from phnrec_tpu_torch.multistream import DENSE_MAX, MultiStreamKWS
from phnrec_tpu_torch.pipeline import SpeechRec
from portbench import kws_work
from portbench.references import stkint_kws
from portbench.writers.stkint_kws import draw_keywords

ROOT = Path(__file__).resolve().parents[1]
N, BLOCK, ROUNDS = 4, 32, 3
ROLL = 1601
# the tiny package's sizes, as the reference reads them
TINY = dict(sample_freq=8000, nbanks=5, lower_freq=64, higher_freq=4000,
            vector_size=200, vector_step=80, sent_mean_norm=False,
            trap_len=31, n_coefs=11, n_phonemes=4, n_classes=4, n_states=3,
            wpenalty=-4.6875, time_pruning=40)
# CPU limits: over 96 frames the port's float32 posteriors and likes
# stay within 2.5e-4 nats of the float64 reference's LR (the largest of
# five package and audio seeds; the TF32 control reads 0.76-1.9) and every
# start is the reference's own (0; the control 0-0.48): x4 of room
LR_ERR = 1e-3
START_GAP = 1e-3


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The tiny KWS package with six generated keywords, four streams of
    one seeded call rolled apart, three blocks through MultiStreamKWS and
    finish(); the waves and each stream's hits."""
    pkg = synth.write_kws_package(tmp_path_factory.mktemp("kwsref") / "p",
                                  "tiny", seed=4, n_keywords=6,
                                  sent_norm=False)
    sr = SpeechRec(pkg, device="cpu")
    L = ROUNDS * BLOCK * 80 + 200 - 80
    base = synth.synth_audio(np.random.default_rng(11), L)
    audio = np.stack([np.roll(base, -s * ROLL) for s in range(N)])
    ms = MultiStreamKWS(sr, N, block_frames=BLOCK)
    assert ms.net_path == "kernel_b"
    buf = torch.from_numpy(audio)
    delivered = [[] for _ in range(N)]
    for r in range(ROUNDS):
        ms.dispatch_from_device_buffer(buf, r * BLOCK * 80)
        for i in range(N):
            delivered[i] += ms.hits_so_far(i)
    res = ms.finish()
    for i in range(N):
        delivered[i] += ms.hits_so_far(i)
    assert [list(d) for d in delivered] == [list(r) for r in res]
    hits = [[(h.start_frames, h.end_frames, h.name, h.score) for h in r]
            for r in res]
    ref = stkint_kws.Reference(TINY, pkg, "cpu")
    lps = [ref.log_posteriors(w, False) for w in audio]
    return pkg, ref, lps, hits


def _passes(v: dict) -> bool:
    return (v["lr_err_nats"] <= LR_ERR and v["start_gap_nats"] <= START_GAP
            and v["missed_hits"] == 0 and v["extra_hits"] == 0)


def test_port_against_reference(served):
    _, ref, lps, hits = served
    v = stkint_kws.judge(ref, lps, hits)
    # LRTrace's comparisons of likes that tie in exact arithmetic may
    # round another way: a hit more or less, its neighbours close by
    assert all(hits) and abs(v["hits"] - v["reference_hits"]) <= 2
    assert _passes(v), v


def _netgen_nodes(path):
    """The port's generated network file as (id, kind, name, flag,
    arcs) tuples, read line by line."""
    out = []
    for line in Path(path).read_text().splitlines():
        f = line.split()
        if not f or f[0].startswith("#") or f[0].startswith("N="):
            continue
        kind, name, flag, arcs = None, None, "", []
        for tok in f[1:]:
            key, _, val = tok.partition("=")
            if key in ("W", "M"):
                kind, name = key, None if val == "!NULL" else val
            elif key == "f":
                flag = val
            elif key == "l":
                arcs[-1] = (arcs[-1][0], float(val))
            else:
                arcs.append((int(tok), 0.0))
        out.append((int(f[0]), kind, name, flag, tuple(arcs)))
    return out


@pytest.mark.parametrize("n_keywords", [None, 6])
def test_network_equals_the_ports_netgen(tmp_path, n_keywords):
    pkg = synth.write_kws_package(tmp_path / "p", "tiny", seed=5,
                                  n_keywords=n_keywords, sent_norm=False)
    SpeechRec(pkg, device="cpu")               # generates tmp/kwsnet
    read = stkint_kws.read_tokens
    mine = stkint_kws.kws_network(
        read(str(Path(pkg) / "phonemes")), read(str(Path(pkg) / "kwlist")),
        stkint_kws.read_lexicon(str(Path(pkg) / "kwlex")))
    assert [tuple(n) for n in mine] == _netgen_nodes(Path(pkg) / "tmp"
                                                     / "kwsnet")


def _shift(hits, d):
    return [[(s + d, e + d, w, x) for s, e, w, x in hs] for hs in hits]


def _rename(hits):
    hs = [list(h) for h in hits]
    s, e, w, x = hs[0][0]
    other = next(h[2] for h in hs[0] if h[2] != w)
    hs[0][0] = (s, e, other, x)
    return hs


def _rescore(hits):
    hs = [list(h) for h in hits]
    s, e, w, x = hs[1][0]
    hs[1][0] = (s, e, w, x + 0.1)
    return hs


def _drop(hits):
    """Stream 0's first hit lost (one the reference is sure of)."""
    return [list(hs[1:]) if b == 0 else list(hs)
            for b, hs in enumerate(hits)]


def _double(hits):
    """Stream 0's first hit given twice, as a block decoded from both its
    ring and its dense records would give it."""
    return [[hs[0]] + list(hs) if b == 0 else list(hs)
            for b, hs in enumerate(hits)]


@pytest.mark.parametrize("spoil", [lambda h: _shift(h, 2), _rename,
                                   _rescore, _drop, _double],
                         ids=["shift_2_frames", "rename", "score_0.1",
                              "dropped", "doubled"])
def test_the_judge_fails_hits_that_are_off(served, spoil):
    _, ref, lps, hits = served
    v = stkint_kws.judge(ref, lps, spoil(hits))
    assert not _passes(v), v


def test_the_cells_keywords_fit_kernel_b_on_every_seed():
    cfg = json.loads((ROOT / "portbench" / "configs"
                      / "en_timit_lcrc_n500.json").read_text())
    phonemes = [f"ph{i:02d}" for i in range(cfg["n_phonemes"])]
    M, E, _, _ = kws_work.network_counts(cfg)
    assert M + E <= DENSE_MAX
    for seed in range(20):
        gen = torch.Generator().manual_seed(seed)
        words = draw_keywords(cfg, gen, "cpu")
        assert sorted(len(p.split()) for p in words.values()) == sorted(
            n for n in cfg["keyword_lengths"]
            for _ in range(cfg["keywords_per_length"]))
        lex = {w: [tuple(p.split())] for w, p in words.items()}
        nodes = stkint_kws.kws_network(phonemes, list(words), lex)
        models = sum(n.kind == "M" for n in nodes)
        assert models == M and models + 3 * models <= DENSE_MAX
