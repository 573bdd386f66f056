"""Plain reference of BUT PhnRec's live keyword spotting on an LCRC
package (``[decoder] type=stkint, mode=kws``), in NumPy and torch, for
judging the hits a program delivered.

Posteriors are ``lcrc_phnloop``'s (float64, or its TF32 control).  The
rest is computed here from the package's own files, in float64:

* **the KWS network** (``kws_network``), built from the package's
  ``phonemes``, ``kwlist`` and ``kwlex`` in the node layout of the
  keyword-network generator (kwsnetg.cpp): 0 start -> 3; 1 terminal;
  2 filler end (sticky, f=F) -> 1; 3 loop null -> the loop phones, the
  word-starts null and 2; the loop phones (sorted, one a phoneme) -> 3
  with l = -1; the word-starts null -> each keyword's start node
  (W=<kw>_B); each start node -> the first phone of each pronunciation;
  the keyword-end nodes (W=<kw>, sticky, f=K) -> 1; then each
  pronunciation's phone chain, its last phone -> its keyword's end.
* **the HMMs** the phoneme list generates (netgen.cpp PhnList2HMMDef):
  three emitting states a phoneme, state j of the list's i-th phoneme
  reading posterior column 3 i + j, entry log 1, self-loop and advance
  log 0.5, exit log 0.5.
* **token passing** over the network (``Reference.scan``): each frame
  the emitting states take the best of their predecessors (ties: the
  model entry before the states, the advance before the self-loop) plus
  the frame's log posterior, then every model's exit passes through the
  null and word nodes within the frame: an arc adds l x lm_scale, a word
  node the word penalty and sets the token's word time to the frame.
  The keyword-end value of a frame is its keyword's best exit into its
  K node, the filler-end value the best loop exit into node 2; both
  sticky nodes hold a frame's tokens only (stkinterface.cpp:279).  Beam
  pruning is off, as in the package.
* **LRTrace** (``lrtrace``), stkinterface.cpp:240-289 and 349-380 with
  the serving defaults (improveKwdEstim off, and the reference's time
  pruning reading keyword 0's candidate end for every keyword): per
  keyword the likelihood ratio LR = keyword end - filler end; a candidate
  grows while LR does not fall; a hypothesis that starts at or after the
  candidate's end flushes it; a candidate time_pruning frames old is
  flushed; ``Done`` flushes the rest.  Score pruning is off.  A hit is
  (start, end, keyword, LR): the frames [start, end) of the keyword.

``Reference(..., control=True)`` takes TF32 products in the posteriors
(``lcrc_phnloop``'s control) and float64 in the rest; ``hits`` then
stands in the program's place.

``judge`` holds the hits of each stream to the float64 reference:

* ``lr_err_nats``: over the program's hits, the largest |score - the
  reference's LR of the keyword at the hit's last frame|;
* ``start_gap_nats``: the reference's best path into the keyword's end
  at the hit's last frame, less its best path that enters the keyword
  at the hit's start frame (0 where the starts agree);
* ``missed_hits`` / ``extra_hits``: the hits are matched one to one on
  (keyword, end frame).  The reference gives a (keyword, end) once, so a
  hit given twice is extra as it stands.  Otherwise the reference's hits
  left over are missed and the program's extra, each excused, not
  counted, where a program whose likes stray from these by less than
  ``stray`` (float32 rounding, relative to the likes' size) may rightly
  hold another LRTrace state from the hit's end to its emission:
  ``lrtrace`` bounds those states beside its own (a decision within the
  stray of a tie, a choice between word times within it on the way to
  the keyword's end, or keyword 0's candidate end, which times every
  keyword's pruning), and the bound closes again at a new hypothesis
  that every such state must start.

Departures from the published description: one pronunciation a keyword,
as the benchmark's packages hold (a keyword with several is refused);
the keyword thresholds, which only
filter the live callback's output in the reference (phnrec.cpp:81-83),
are not applied, as the program's ``hits_so_far`` applies none; a
hypothesis's start is its keyword's entry frame, as the program's word
time is (STK's word-link record time).

Nothing here imports the program or JAX.
"""

from __future__ import annotations

import os
from collections import Counter
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from portbench.references import lcrc_phnloop

LOG_HALF = lcrc_phnloop.LOG_HALF
NEG_INF = -np.inf
BIG = 1e30                  # a reading where a hit has no reference value
# How far a float32 program's likes may stray from these, for the bound
# of missed_hits and extra_hits.  Float32 sums round in proportion to
# their size: on the H100 the program's LR at a hit strays from the float64
# reference's by up to 1.1e-6 of the filler end's like (0.17 nats at -153k,
# the end of a 307 s call), and its hits part from the reference's past the
# bound only with STRAY_REL below 3e-7 (two of the cell's runs, judged again
# at smaller values).  STRAY_REL is ten times that; STRAY_FLOOR_NATS holds
# over a call's first frames.
STRAY_REL = 3e-6
STRAY_FLOOR_NATS = 1e-3


def stray(like):
    """The bound of a program's error on values of the size of ``like``,
    nats."""
    return np.maximum(STRAY_REL * np.abs(like), STRAY_FLOOR_NATS)


class Node(NamedTuple):
    """One network node: its id, ``"W"`` (a null or word node) or ``"M"``
    (a model), its word or model name (None for !NULL), its flag
    (``"F"``, ``"K"`` or ``""``) and its arcs [(target id, l)]."""

    id: int
    kind: str
    name: Optional[str]
    flag: str
    arcs: Tuple[Tuple[int, float], ...]


def read_tokens(path: str) -> List[str]:
    with open(path, encoding="latin-1") as f:
        return f.read().split()


def read_lexicon(path: str) -> Dict[str, List[Tuple[str, ...]]]:
    """word -> its pronunciations (a line ``word<TAB>phones`` each)."""
    out: Dict[str, List[Tuple[str, ...]]] = {}
    with open(path, encoding="latin-1") as f:
        for line in f:
            parts = line.split()
            if parts:
                out.setdefault(parts[0], []).append(tuple(parts[1:]))
    return out


def kws_network(phonemes: Sequence[str], keywords: Sequence[str],
                lexicon: Dict[str, List[Tuple[str, ...]]]) -> List[Node]:
    """The keyword network's nodes in the generator's layout: the loop
    over the sorted distinct phonemes, the sorted distinct keywords, each
    keyword's distinct pronunciations in sorted order."""
    phn = sorted(set(phonemes))
    words = sorted(set(keywords))
    prons = {w: sorted(set(lexicon.get(w, ()))) for w in words}
    for w in words:
        if not prons[w]:
            raise ValueError(f"no pronunciation for keyword {w!r}")
    P, K = len(phn), len(words)
    nodes = [Node(0, "W", None, "", ((3, 0.0),)),
             Node(1, "W", None, "", ()),
             Node(2, "W", None, "F", ((1, 0.0),)),
             Node(3, "W", None, "", tuple((4 + i, 0.0) for i in range(P))
                  + ((4 + P, 0.0), (2, 0.0)))]
    nodes += [Node(4 + i, "M", p, "", ((3, -1.0),))
              for i, p in enumerate(phn)]
    starts = 5 + P                       # the keyword start nodes
    ends = starts + K                    # the keyword end nodes
    nodes.append(Node(4 + P, "W", None, "",
                      tuple((starts + i, 0.0) for i in range(K))))
    chain = ends + K
    for i, w in enumerate(words):
        arcs = []
        for pr in prons[w]:
            arcs.append((chain, 0.0))
            chain += len(pr)
        nodes.append(Node(starts + i, "W", f"{w}_B", "", tuple(arcs)))
    for i, w in enumerate(words):
        nodes.append(Node(ends + i, "W", w, "K", ((1, 0.0),)))
    nid = ends + K
    for i, w in enumerate(words):
        for pr in prons[w]:
            for j, p in enumerate(pr):
                nxt = nid + 1 if j < len(pr) - 1 else ends + i
                nodes.append(Node(nid, "M", p, "", ((nxt, 0.0),)))
                nid += 1
    return nodes


class Tables(NamedTuple):
    """The network as the token passing reads it."""

    keywords: List[str]      # in the network's order (keyword 0 first)
    col: np.ndarray          # [M, 3] posterior column of each state
    loop: np.ndarray         # [M] bool: a loop phone
    loop_l: np.ndarray       # [M] the loop phone's arc into the loop null
    pred: np.ndarray         # [M] the chain phone before (-1: none)
    first: np.ndarray        # [M] bool: a keyword's first phone
    last: np.ndarray         # [K] each keyword's last phone
    start_w: float           # loop null -> a keyword's first phone
    filler_w: float          # loop null -> filler end
    end_w: float             # last phone -> keyword end
    init_loop: float         # START -> the loop null
    chains: List[Tuple[int, ...]]   # each keyword's phones


def network_tables(nodes: List[Node], phonemes: Sequence[str],
                   wpenalty: float, lm_scale: float = 1.0) -> Tables:
    """Read the layout ``kws_network`` writes: the models' posterior
    columns (the phoneme list's order), the loop phones and their arcs,
    the chains, and the null and word nodes' weights along each route
    (an arc adds l x lm_scale, a word node the word penalty).  One
    pronunciation a keyword."""
    by_id = {n.id: n for n in nodes}
    word = lambda n: wpenalty if n.name is not None else 0.0  # noqa: E731
    arc = lambda a, b: lm_scale * dict(by_id[a].arcs)[b]      # noqa: E731
    models = [n for n in nodes if n.kind == "M"]
    index = {n.id: i for i, n in enumerate(models)}
    col_of = {p: 3 * i for i, p in enumerate(phonemes)}
    start = nodes[0]
    (loop_null, _), = start.arcs
    filler = next(n for n in nodes if n.flag == "F")
    M = len(models)
    col = np.array([[col_of[n.name] + j for j in range(3)] for n in models])
    loop = np.zeros(M, bool)
    loop_l = np.zeros(M)
    pred = np.full(M, -1)
    first = np.zeros(M, bool)
    keywords, chains, weights = [], [], set()
    filler_w = None
    for tgt, _ in by_id[loop_null].arcs:
        n = by_id[tgt]
        if n.kind == "M":
            if arc(loop_null, n.id) != 0.0:
                raise ValueError("a weighted arc into a loop phone")
            loop[index[n.id]] = True
            loop_l[index[n.id]] = arc(n.id, loop_null)
        elif n is filler:
            filler_w = arc(loop_null, n.id) + word(n)
        else:                                    # the word-starts null
            for b, _ in n.arcs:
                bn = by_id[b]
                if len(bn.arcs) != 1:
                    raise ValueError(f"{bn.name}: the reference takes one "
                                     "pronunciation a keyword")
                (f, _), = bn.arcs
                start_w = arc(loop_null, n.id) + word(n) + arc(n.id, b) + \
                    word(bn) + arc(b, f)
                first[index[f]] = True
                phones, cur = [], by_id[f]
                while cur.kind == "M":
                    phones.append(index[cur.id])
                    (nxt, _), = cur.arcs
                    if by_id[nxt].kind == "M":
                        pred[index[nxt]] = index[cur.id]
                        if arc(cur.id, nxt) != 0.0:
                            raise ValueError("a weighted chain arc")
                    cur_id, cur = cur.id, by_id[nxt]
                if cur.flag != "K":
                    raise ValueError("a chain that ends in no keyword")
                end_w = arc(cur_id, cur.id) + word(cur)
                weights.add((start_w, end_w))
                keywords.append(cur.name)
                chains.append(tuple(phones))
    if len(weights) != 1:
        raise ValueError("keyword starts or ends that weigh unlike")
    (start_w, end_w), = weights
    return Tables(keywords, col, loop, loop_l, pred, first,
                  np.array([c[-1] for c in chains]), start_w, filler_w,
                  end_w, arc(start.id, loop_null) + word(by_id[loop_null]),
                  chains)


class Scan(NamedTuple):
    """Token passing over one or more streams of T frames."""

    word: np.ndarray      # [B, T, K] keyword-end values (-inf: none)
    start: np.ndarray     # [B, T, K] their word times (entry frames)
    start_lo: np.ndarray  # [B, T, K] the earliest and the latest word time
    start_hi: np.ndarray  # of the paths that came within the margin of
    #                       the best at a choice on its way
    filler: np.ndarray    # [B, T] filler-end values
    entry: np.ndarray     # [B, T + 1] a keyword's entry value at each
    #                       frame boundary (its first phone's, before the
    #                       chain)


class Doubt(NamedTuple):
    """Where a program's LRTrace may rightly part from the reference's."""

    unsure: np.ndarray    # [B, T, K] after frame t the keyword's tracker
    #                       state may differ from the reference's
    cand_end: np.ndarray  # [B, T, K] the reference's candidate end after t


class Hit(NamedTuple):
    start: int
    end: int
    word: str
    score: float


class Reference(lcrc_phnloop.Reference):
    """The package's model and KWS decoding in float64, or the TF32
    control of its posteriors."""

    def __init__(self, cfg: dict, package: str, device, control=False):
        super().__init__(cfg, package, device, control)
        self.nodes = kws_network(
            self.phonemes, read_tokens(os.path.join(package, "kwlist")),
            read_lexicon(os.path.join(package, "kwlex")))
        self.tables = network_tables(self.nodes, self.phonemes,
                                     float(cfg["wpenalty"]))
        self.time_pruning = int(cfg["time_pruning"])

    @property
    def keywords(self) -> List[str]:
        return self.tables.keywords

    def scan(self, lps: Sequence[np.ndarray]) -> Scan:
        """Token passing over streams of equal length: each stream's
        keyword-end and filler-end values a frame, and where a choice
        between tokens of different word times on the way to a keyword's
        end came within twice ``stray`` of a tie."""
        tb = self.tables
        T = lps[0].shape[0]
        if any(lp.shape[0] != T for lp in lps):
            raise ValueError("streams of unequal length")
        B, M = len(lps), tb.col.shape[0]
        K = len(tb.keywords)
        lp3 = np.stack(lps, 1)                              # [T, B, C]
        a = np.full((B, M, 3), NEG_INF)
        wt = np.zeros((B, M, 3), np.int64)
        lo, hi = wt.copy(), wt.copy()
        loop_in = np.full(B, tb.init_loop)
        ent = np.where(tb.loop, loop_in[:, None],
                       np.where(tb.first, loop_in[:, None] + tb.start_w,
                                NEG_INF))
        ent_wt = np.zeros((B, M), np.int64)
        ent_lo, ent_hi = ent_wt.copy(), ent_wt.copy()
        last = tb.last
        chain = np.nonzero(tb.pred >= 0)[0]
        word = np.full((B, T, K), NEG_INF)
        start = np.zeros((B, T, K), np.int64)
        start_lo, start_hi = start.copy(), start.copy()
        filler = np.empty((B, T))
        entry = np.empty((B, T + 1))
        entry[:, 0] = loop_in + tb.start_w

        def pick(x, y, take, xs, ys):
            """The chosen token's value and word times (range widened
            where the other came within the margin)."""
            with np.errstate(invalid="ignore"):
                tie = np.abs(x - y) < 2 * stray(x)
            w, l, h = (np.where(take, u, v) for u, v in zip(xs, ys))
            l = np.where(tie, np.minimum(xs[1], ys[1]), l)
            h = np.where(tie, np.maximum(xs[2], ys[2]), h)
            return np.where(take, x, y), w, l, h

        for t in range(T):
            o = lp3[t][:, tb.col]
            stay = a + LOG_HALF
            # state 0: the entry wins ties; states 1, 2: the advance
            n0, w0, l0, h0 = pick(ent, stay[:, :, 0], ent >= stay[:, :, 0],
                                  (ent_wt, ent_lo, ent_hi),
                                  (wt[:, :, 0], lo[:, :, 0], hi[:, :, 0]))
            n12, w12, l12, h12 = pick(
                stay[:, :, :2], stay[:, :, 1:],
                stay[:, :, :2] >= stay[:, :, 1:],
                (wt[:, :, :2], lo[:, :, :2], hi[:, :, :2]),
                (wt[:, :, 1:], lo[:, :, 1:], hi[:, :, 1:]))
            a = np.concatenate([n0[:, :, None], n12], 2) + o
            wt = np.concatenate([w0[:, :, None], w12], 2)
            lo = np.concatenate([l0[:, :, None], l12], 2)
            hi = np.concatenate([h0[:, :, None], h12], 2)
            ex = a[:, :, 2] + LOG_HALF
            loop_out = np.max(np.where(tb.loop, ex + tb.loop_l, NEG_INF),
                              axis=1)
            filler[:, t] = loop_out + tb.filler_w
            word[:, t] = ex[:, last] + tb.end_w
            start[:, t] = wt[:, last, 2]
            start_lo[:, t] = lo[:, last, 2]
            start_hi[:, t] = hi[:, last, 2]
            entry[:, t + 1] = loop_out + tb.start_w
            ent = np.where(tb.loop, loop_out[:, None],
                           np.where(tb.first,
                                    loop_out[:, None] + tb.start_w,
                                    NEG_INF))
            ent[:, chain] = ex[:, tb.pred[chain]]
            ent_wt = np.where(tb.first, t + 1, 0)[None].repeat(B, 0)
            ent_lo, ent_hi = ent_wt.copy(), ent_wt.copy()
            for d, src in ((ent_wt, wt), (ent_lo, lo), (ent_hi, hi)):
                d[:, chain] = src[:, tb.pred[chain], 2]
        return Scan(word, start, start_lo, start_hi, filler, entry)

    def lrtrace(self, sc: Scan) -> Tuple[List[List[Hit]], Doubt]:
        """Each stream's hits, and where a program whose LRs stray from
        these by less than ``stray`` of the frame's filler end may hold
        another tracker state.

        Beside the reference's tracker runs a bound of every state such
        a program may hold: its candidate end in [e_lo, e_hi], its
        candidate LR in [l_lo, l_hi], and whether its dumped flag or its
        flushes may differ (``apart``).  Each decision is taken for the
        bound as must / may: sure where it holds for every state and LR
        in the bound.  The bound is the reference's own state again after
        a new hypothesis that both must start."""
        B, T, K = sc.word.shape
        tp = self.time_pruning
        active = np.isfinite(sc.word) & np.isfinite(sc.filler)[:, :, None]
        with np.errstate(invalid="ignore"):
            lr_all = np.where(active, sc.word - sc.filler[:, :, None],
                              NEG_INF)
        last_lr = np.full((B, K), NEG_INF)
        cand_lr = np.full((B, K), NEG_INF)
        cand_start = np.zeros((B, K), np.int64)
        cand_end = np.zeros((B, K), np.int64)
        dumped = np.zeros((B, K), bool)
        e_lo = np.zeros((B, K), np.int64)
        e_hi = np.zeros((B, K), np.int64)
        l_lo = np.full((B, K), NEG_INF)
        l_hi = np.full((B, K), NEG_INF)
        apart = np.zeros((B, K), bool)
        doubt = Doubt(np.zeros((B, T, K), bool),
                      np.zeros((B, T, K), np.int64))
        events = []          # (stream, frame, slot, keyword, start, end, lr)

        def flush(cond, t, slot):
            do = cond & (cand_end != 0) & ~dumped
            for b, k in zip(*np.nonzero(do)):
                events.append((b, t, slot, k, cand_start[b, k],
                               cand_end[b, k], cand_lr[b, k]))
            return dumped | do

        with np.errstate(invalid="ignore"):
            for t in range(T):
                act = active[:, t]
                lr = lr_all[:, t]
                ws = sc.start[:, t]
                half = stray(sc.filler[:, t])[:, None]
                margin = 2 * half
                # the bound's decisions, (must, may)
                d = lr - last_lr
                grow = (act & (d >= margin), act & (d > -margin))
                ge = (lr - half >= l_hi, lr + half >= l_lo)
                nh = (e_hi <= sc.start_lo[:, t], e_lo <= sc.start_hi[:, t])
                ev1_b = (grow[0] & nh[0], grow[1] & nh[1])
                take_b = (grow[0] & (ge[0] | nh[0]),
                          grow[1] & (ge[1] | nh[1]))
                # the reference's
                growing = act & (lr >= last_lr)
                new_hyp = growing & (cand_end <= ws)
                take = growing & ((lr >= cand_lr) | new_hyp)
                ev1 = new_hyp & take
                dumped = flush(ev1, t, 0) & ~ev1
                cand_start = np.where(take, ws, cand_start)
                cand_end = np.where(take, t + 1, cand_end)
                cand_lr = np.where(take, lr, cand_lr)
                last_lr = np.where(act, lr, NEG_INF)
                # the bound after the takes
                must, may = take_b
                e_lo = np.where(must, t + 1, e_lo)
                e_hi = np.where(may, t + 1, e_hi)
                l_lo = np.where(must, lr - half,
                                np.where(may, np.minimum(l_lo, lr - half),
                                         l_lo))
                l_hi = np.where(must, lr + half,
                                np.where(may, np.maximum(l_hi, lr + half),
                                         l_hi))
                apart = np.where(ev1 & ev1_b[0], False,
                                 apart | (ev1_b[0] != ev1_b[1])
                                 | (ev1_b[0] != ev1))
                # time pruning by keyword 0's candidate end
                ref_end = np.broadcast_to(cand_end[:, :1], cand_end.shape)
                stale = act & (ref_end != 0) & ((t + 1) - ref_end >= tp)
                cut = t + 1 - tp
                must0 = (e_lo[:, :1] >= 1) & (e_hi[:, :1] <= cut)
                may0 = np.maximum(e_lo[:, :1], 1) <= np.minimum(
                    e_hi[:, :1], cut)
                apart |= act & ~(dumped & ~apart) & (
                    (must0 != may0) | (must0 != stale))
                dumped = flush(stale, t, 1)
                doubt.unsure[:, t] = apart | (e_lo != cand_end) | \
                    (e_hi != cand_end)
                doubt.cand_end[:, t] = cand_end
        events.sort(key=lambda e: (e[0], e[1], e[2], e[3]))
        hits: List[List[Hit]] = [[] for _ in range(B)]
        kws = self.keywords
        for b, _, _, k, s, e, lr in events:
            hits[b].append(Hit(int(s), int(e), kws[k], float(lr)))
        for b in range(B):               # Done: the outstanding candidates
            for k in range(K):
                if cand_end[b, k] != 0 and not dumped[b, k]:
                    hits[b].append(Hit(int(cand_start[b, k]),
                                       int(cand_end[b, k]), kws[k],
                                       float(cand_lr[b, k])))
        return hits, doubt

    def hits(self, lps: Sequence[np.ndarray]) -> List[List[Hit]]:
        """Each stream's hits, in the order the live callback delivers
        them."""
        return self.lrtrace(self.scan(lps))[0]

    def entered_at(self, sc: Scan, b: int, k: int, starts: np.ndarray,
                   ends: np.ndarray, lp: np.ndarray) -> np.ndarray:
        """The best path of stream b into keyword k's end at frame
        ``ends - 1`` that enters the keyword at frame ``starts`` (-inf
        where none), all pairs at once.  Along a chain every state is
        reached from the one before it at log 0.5 (an advance, or an exit
        and the next model's entry at log 1) or from itself at log 0.5;
        the first from the keyword's entry value, at its start only."""
        tb = self.tables
        dur = ends - starts
        cols = tb.col[list(tb.chains[k])].reshape(-1)        # [3 L]
        a = np.full((len(starts), len(cols)), NEG_INF)
        for d in range(int(dur.max(initial=0))):
            live = d < dur
            o = lp[np.minimum(starts + d, lp.shape[0] - 1)][:, cols]
            into = sc.entry[b, starts] if d == 0 else \
                np.full(len(starts), NEG_INF)
            prev = np.concatenate([into[:, None], a[:, :-1] + LOG_HALF], 1)
            a = np.where(live[:, None], np.maximum(a + LOG_HALF, prev) + o,
                         a)
        return a[:, -1] + LOG_HALF + tb.end_w


def judge(ref: Reference, lps: Sequence[np.ndarray], hits) -> dict:
    """The program's hits of each stream (lists of (start, end, keyword,
    score)) held to the float64 reference."""
    sc = ref.scan(lps)
    want, doubt = ref.lrtrace(sc)
    kidx = {k: i for i, k in enumerate(ref.keywords)}
    B, T, K = sc.word.shape
    lr_err = start_gap = 0.0
    missed = extra = excused = 0
    counted = []             # (side, stream, keyword, end) of each count
    for b in range(B):
        got = list(hits[b])
        if not got:
            h = np.zeros((0, 3), np.int64)
            score = np.zeros(0)
        else:
            h = np.array([(s, e, kidx.get(w, -1)) for s, e, w, _ in got],
                         np.int64)
            score = np.array([x[3] for x in got], np.float64)
        ok = (h[:, 2] >= 0) & (h[:, 1] >= 1) & (h[:, 1] <= T) & \
            (h[:, 0] >= 0) & (h[:, 0] < h[:, 1])
        if not ok.all():
            lr_err = start_gap = BIG
        s, e, k = (h[ok, i] for i in range(3))
        fr = e - 1
        lr = sc.word[b, fr, k] - sc.filler[b, fr]
        err = np.where(np.isfinite(lr), np.abs(score[ok] - lr), BIG)
        lr_err = max(lr_err, float(err.max(initial=0.0)))
        # starts: where the program's start is not the reference's own
        diff = s != sc.start[b, fr, k]
        for kk in np.unique(k[diff]):
            sel = diff & (k == kk)
            got_v = ref.entered_at(sc, b, int(kk), s[sel], e[sel], lps[b])
            best = sc.word[b, fr[sel], kk]
            gap = np.where(np.isfinite(got_v), best - got_v, BIG)
            start_gap = max(start_gap, float(gap.max(initial=0.0)))
        # one to one on (keyword, end frame): the reference gives a
        # (keyword, end) once, so a hit given twice is extra as it
        # stands; a hit left over otherwise counts unless the tracker
        # state that made it, from its end to its emission, was unsure
        mine = {(kidx[x.word], x.end) for x in want[b]}
        theirs = Counter(zip(k.tolist(), e.tolist()))
        for (kk, end), n in theirs.items():
            extra += n - 1
            counted += [("extra", b, ref.keywords[kk], end)] * (n - 1)
        unsure = np.concatenate([np.zeros((1, K), np.int64), np.cumsum(
            doubt.unsure[b], 0)])
        ce = doubt.cand_end[b]
        run = np.empty_like(ce)         # the last frame of ce's stretch
        run[T - 1] = T - 1
        for t in range(T - 2, -1, -1):
            run[t] = np.where(ce[t + 1] == ce[t], run[t + 1], t)
        for side, left in (("missed", mine - set(theirs)),
                           ("extra", set(theirs) - mine)):
            for kk, end in sorted(left):
                f = end - 1
                hi = min(run[f, kk] + 1, T - 1) if ce[f, kk] == end else f
                if unsure[hi + 1, kk] - unsure[f, kk]:
                    excused += 1
                    continue
                if side == "missed":
                    missed += 1
                else:
                    extra += 1
                counted.append((side, b, ref.keywords[kk], end))
    return dict(lr_err_nats=lr_err, start_gap_nats=start_gap,
                missed_hits=missed, extra_hits=extra,
                hits=int(sum(len(h) for h in hits)),
                reference_hits=int(sum(len(h) for h in want)),
                excused_hits=excused, counted=counted[:20])

