"""The work of the keyword-spotting kernels from their launches' shapes
and the configuration: kernel B (the dense network step,
ops/netstep.py) and kernel F (the LRTrace scan, ops/lrtrace.py), and
their shares of their rooflines.

The byte and operation counts are those chip_smoke.py gives the kernel
table (``check_netstep``, ``check_lrtrace``), over every row a launch
was handed (padding included, as ``mlp_roofline`` counts A's rows).  The
network's sizes follow the keyword network the configuration generates:
a loop of the phonemes plus one chain a keyword phone, three states a
model; sinks: the terminal, the filler end and one end a keyword."""

from __future__ import annotations

from typing import Tuple

from portbench.work import bound_s


def network_counts(cfg: dict) -> Tuple[int, int, int, int]:
    """(models M, states E, sinks S, live closure and sink edges) of the
    configuration's KWS network."""
    P, S_M = cfg["n_phonemes"], cfg["n_states"]
    lengths = [n for n in cfg["keyword_lengths"]
               for _ in range(cfg["keywords_per_length"])]
    K, phones = len(lengths), sum(lengths)
    M = P + phones
    # closure: loop -> loop, loop -> each keyword's first phone, along
    # the chains; sinks: loop -> filler end and terminal, each keyword's
    # last phone -> its end and the terminal
    nnz = P * P + P * K + (phones - K) + 2 * P + 2 * K
    return M, M * S_M, 2 + K, nnz


def netstep_work(rows: int, F: int, n: int, E: int, M: int, S: int,
                 nnz: int) -> Tuple[int, int]:
    """(bytes, operations) of one kernel-B launch over ``rows`` frame
    rows: the rows' observations read, the sink records (values and word
    times) written, the carry read and written, the rows' counts; about
    seven operations a state, one a model exit and two a live edge."""
    n_bytes = rows * E * 4 + F * n * S * 8 + 2 * n * (2 * E + 2 * M) * 4 \
        + n * 12
    return n_bytes, rows * (7 * E + M + 2 * nnz)


def lrtrace_work(rows: int, F: int, n: int, K: int) -> Tuple[int, int]:
    """(bytes, operations) of one kernel-F launch over ``rows`` frame
    rows: the keyword and filler values and the word times read, both
    event records written (14 bytes a keyword and frame), the state read
    and written; about 20 operations a keyword and row."""
    n_bytes = rows * (2 * K + 1) * 4 + 2 * n * F * K * 14 + \
        2 * n * K * 21 + n * 8
    return n_bytes, rows * K * 20


def netstep_roofline(t):
    """Kernel B's bound summed over its launches (``Trace.launches["B"]``:
    obs [F, n, E] first) over B's device time, %."""
    calls = t.launches.get("B", [])
    dev_s = t.kernel_s.get("B", 0.0)
    if not calls or dev_s <= 0.0:
        return None
    M, _, S, nnz = network_counts(t.cfg)
    total = 0.0
    for c in calls:
        F, n, E = c.shapes[0]
        total += bound_s(*netstep_work(F * n, F, n, E, M, S, nnz))
    return 100.0 * total / dev_s


def lrtrace_roofline(t):
    """Kernel F's bound summed over its launches (``Trace.launches["F"]``:
    sink_val [F, n, S], sink_wt, word_sinks [K], ...) over F's device
    time, %."""
    calls = t.launches.get("F", [])
    dev_s = t.kernel_s.get("F", 0.0)
    if not calls or dev_s <= 0.0:
        return None
    total = 0.0
    for c in calls:
        F, n, _ = c.shapes[0]
        K, = c.shapes[2]
        total += bound_s(*lrtrace_work(F * n, F, n, K))
    return 100.0 * total / dev_s
