"""Finite-state machine/transducer library (reference: fsm.{cpp,h}).

Copy of phnrec_tpu/fsm.py (host code without JAX, kept in step with it).

Covers the reference FSM library's public surface: AT&T binary/text I/O,
symbol walking (FSM::GetNextNodeIS, fsm.cpp:175-188), arc sorting
(SortArcs + the CmpArc* orders, fsm.h:175-182), label surgery
(RemoveArcs / ReplaceLabels, fsm.cpp:1104-1433), tropical/log semiring
operations, epsilon-aware composition (FSM_ALGO::compose,
fsm.cpp:923-1101) and the SVite node-graph conversion (Convert2SVite,
fsm.cpp:1273-1406).

Composition note: the reference's compose writes the MATCHED symbol to
both sides of the new arc (fsm.cpp:1066-1068) and advances only the A
cursor on a match, pairing at most one B arc per label
(fsm.cpp:1085-1094).  This module implements standard FST composition
(labelFrom from A, labelTo from B; full product over equal-label runs;
terminal weight = semiring-times of the two terminals) — a strict
superset of what the reference's G2P stack exercises; the deviations are
deliberate fixes, not omissions.

Binary layout (FSM::LoadBinAtt, fsm.cpp:444-600; ATT_BIN_* structs,
fsm.h:86-108), all little-endian:
  signature line "FSM\\n" (or "FSM/failure\\n" + uint32 failure label
  + "FSM\\n"), then uint32 {fsmClass, semiring, nNodes, startNode}, then
  per node: float potential, float termWeight, uint32 nArcs, followed by
  nArcs x {uint32 labelFrom, uint32 labelTo, float weight, uint32 target}.
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

SEMIRING_TROPICAL = 0
SEMIRING_LOG = 1

LABEL_INPUT = 0
LABEL_OUTPUT = 1

NF_MODEL = 1
NF_WORD = 2

EPS = 0                      # label 0 is epsilon (fsm.cpp:960,1003)


def sr_times(semiring: int, a: float, b: float) -> float:
    """Semiring multiply: weight accumulation along a path.  Both the
    tropical (min, +) and log (-logadd, +) semirings use +."""
    return a + b


def sr_plus(semiring: int, a: float, b: float) -> float:
    """Semiring add: combining alternative paths."""
    if semiring == SEMIRING_TROPICAL:
        return min(a, b)
    # log semiring: -log(e^-a + e^-b), stable form
    m = min(a, b)
    return m - math.log1p(math.exp(-(abs(a - b))))


@dataclass
class Arc:
    label_from: int
    label_to: int
    weight: float
    target: int              # node index


@dataclass
class FsmNode:
    potential: float = 0.0
    term_weight: float = float("inf")   # inf = non-terminal
    arcs: List[Arc] = field(default_factory=list)
    flag: int = 0                       # NF_MODEL / NF_WORD after SVite

    @property
    def is_terminal(self) -> bool:
        return self.term_weight != float("inf")


@dataclass
class FSM:
    nodes: List[FsmNode] = field(default_factory=list)
    start: int = 0
    fsm_class: int = 0
    semiring: int = SEMIRING_TROPICAL
    failure_label: Optional[int] = None

    def add_node(self) -> int:
        self.nodes.append(FsmNode())
        return len(self.nodes) - 1

    def add_arc(self, src: int, label_from: int, label_to: int,
                weight: float, target: int) -> None:
        self.nodes[src].arcs.append(Arc(label_from, label_to, weight,
                                        target))

    def next_node_is(self, node: int, isymbol: int) -> Optional[int]:
        """First arc with matching input label (fsm.cpp:175-188)."""
        for arc in self.nodes[node].arcs:
            if arc.label_from == isymbol:
                return arc.target
        return None

    def next_node_os(self, node: int, osymbol: int) -> Optional[int]:
        """First arc with matching output label (GetNextNodeOS)."""
        for arc in self.nodes[node].arcs:
            if arc.label_to == osymbol:
                return arc.target
        return None

    def arcs_from(self, node: int) -> List[Arc]:
        return self.nodes[node].arcs

    @property
    def n_arcs(self) -> int:
        return sum(len(n.arcs) for n in self.nodes)

    # ---- arc ordering (SortArcs + CmpArc*, fsm.h:175-182) -------------
    def sort_arcs(self, key: str = "target") -> None:
        """Stable per-node arc sort.  key: 'target' (CmpArcToNodeId),
        'label_from' (CmpArcLabelFrom) or 'label_to' (CmpArcLabelTo)."""
        getters = {
            "target": lambda a: a.target,
            "label_from": lambda a: a.label_from,
            "label_to": lambda a: a.label_to,
        }
        g = getters[key]
        for node in self.nodes:
            node.arcs.sort(key=g)

    # ---- label surgery (fsm.cpp:1104-1433) ----------------------------
    def remove_arcs(self, min_label: int, max_label: int,
                    label_type: int = LABEL_INPUT) -> None:
        """Drop every arc whose input (or output) label falls in
        [min_label, max_label] (FSM::RemoveArcs, fsm.cpp:1104-1160)."""
        for node in self.nodes:
            node.arcs = [
                a for a in node.arcs
                if not (min_label <= (a.label_from if label_type ==
                                      LABEL_INPUT else a.label_to)
                        <= max_label)
            ]

    def replace_labels(self, mapping: Dict[int, int],
                       label_type: int = LABEL_INPUT) -> None:
        """FSM::ReplaceLabels (fsm.cpp:1408-1432)."""
        for node in self.nodes:
            for a in node.arcs:
                if label_type == LABEL_INPUT:
                    a.label_from = mapping.get(a.label_from, a.label_from)
                else:
                    a.label_to = mapping.get(a.label_to, a.label_to)

    def remove_free_nodes(self) -> None:
        """Drop nodes unreachable from the start (RemoveFreeNodes) and
        renumber (RenumberNodeIds)."""
        seen = {self.start}
        stack = [self.start]
        while stack:
            for a in self.nodes[stack.pop()].arcs:
                if a.target not in seen:
                    seen.add(a.target)
                    stack.append(a.target)
        remap = {}
        new_nodes = []
        for i, node in enumerate(self.nodes):
            if i in seen:
                remap[i] = len(new_nodes)
                new_nodes.append(node)
        for node in new_nodes:
            for a in node.arcs:
                a.target = remap[a.target]
        self.nodes = new_nodes
        self.start = remap[self.start]

    # ---- paths --------------------------------------------------------
    def shortest_distance(self, tol: float = 1e-10,
                          max_relax: Optional[int] = None) -> List[float]:
        """Semiring distance from the start to every node: tropical =
        shortest path, log = minus-log of the path-weight sum.

        Generic single-source algorithm (the residual formulation used
        for non-idempotent semirings): every node carries the mass not
        yet propagated onward, so each path contributes exactly once —
        naive Bellman rounds would re-add already-accumulated mass in the
        log semiring.  Cycles converge geometrically; ``max_relax`` caps
        the work on pathological non-convergent weights."""
        INF = float("inf")
        n = len(self.nodes)
        dist = [INF] * n
        resid = [INF] * n
        dist[self.start] = resid[self.start] = 0.0
        queue = [self.start]
        queued = [False] * n
        queued[self.start] = True
        steps = 0
        cap = max_relax if max_relax is not None else 10000 * (n + 1)
        while queue and steps < cap:
            steps += 1
            q = queue.pop(0)
            queued[q] = False
            rho, resid[q] = resid[q], INF
            if rho == INF:
                continue
            for a in self.nodes[q].arcs:
                m = sr_times(self.semiring, rho, a.weight)
                nd = m if dist[a.target] == INF else \
                    sr_plus(self.semiring, dist[a.target], m)
                if dist[a.target] == INF or nd < dist[a.target] - tol:
                    dist[a.target] = nd
                    resid[a.target] = m if resid[a.target] == INF else \
                        sr_plus(self.semiring, resid[a.target], m)
                    if not queued[a.target]:
                        queued[a.target] = True
                        queue.append(a.target)
        return dist

    # ---- SVite/STK node-graph conversion (fsm.cpp:1273-1406) ----------
    def convert2_svite(self) -> None:
        """Rewrite the arc-labelled transducer into a node-labelled graph:
        every nonzero input label becomes a MODEL node, every nonzero
        output label a WORD node (label id stored in node.potential, kind
        in node.flag); labelled arcs become eps arcs through the new
        nodes.  Nodes with exactly one incoming arc are reused in place of
        inserting a new one, as the reference does."""
        n_bw = [0] * len(self.nodes)
        for node in self.nodes:
            for a in node.arcs:
                n_bw[a.target] += 1
        for node in self.nodes:
            node.potential = -1.0
            node.flag = 0
        n_orig = len(self.nodes)
        for node in list(self.nodes[:n_orig]):
            for arc in list(node.arcs):
                lf, lt = arc.label_from, arc.label_to
                if lf != EPS and lt != EPS:
                    mi = self.add_node()
                    self.nodes[mi].potential = float(lf)
                    self.nodes[mi].flag = NF_MODEL
                    if arc.target < n_orig and n_bw[arc.target] == 1:
                        wi = arc.target
                    else:
                        wi = self.add_node()
                        self.add_arc(wi, EPS, EPS, 0.0, arc.target)
                    self.nodes[wi].potential = float(lt)
                    self.nodes[wi].flag = NF_WORD
                    self.add_arc(mi, EPS, EPS, 0.0, wi)
                    arc.target = mi
                    arc.label_from = arc.label_to = EPS
                elif lf != EPS:
                    if arc.target < n_orig and n_bw[arc.target] == 1:
                        self.nodes[arc.target].potential = float(lf)
                        self.nodes[arc.target].flag = NF_MODEL
                    else:
                        mi = self.add_node()
                        self.nodes[mi].potential = float(lf)
                        self.nodes[mi].flag = NF_MODEL
                        self.add_arc(mi, EPS, EPS, 0.0, arc.target)
                        arc.target = mi
                    arc.label_from = arc.label_to = EPS
                elif lt != EPS:
                    if arc.target < n_orig and n_bw[arc.target] == 1:
                        self.nodes[arc.target].potential = float(lt)
                        self.nodes[arc.target].flag = NF_WORD
                    else:
                        wi = self.add_node()
                        self.nodes[wi].potential = float(lt)
                        self.nodes[wi].flag = NF_WORD
                        self.add_arc(wi, EPS, EPS, 0.0, arc.target)
                        arc.target = wi
                    arc.label_from = arc.label_to = EPS

    # ------------------------------------------------------------------
    @classmethod
    def load_bin_att(cls, path: str) -> "FSM":
        with open(path, "rb") as f:
            data = f.read()
        pos = data.index(b"\n")
        signature = data[:pos].decode("latin-1")
        pos += 1
        failure = None
        if signature == "FSM/failure":
            (failure,) = struct.unpack_from("<I", data, pos)
            pos += 4
            end = data.index(b"\n", pos)
            signature = data[pos:end].decode("latin-1")
            pos = end + 1
        if signature != "FSM":
            raise ValueError(f"unsupported FSM format {signature!r}")
        fsm_class, semiring, n_nodes, start = struct.unpack_from(
            "<4I", data, pos)
        pos += 16
        fsm = cls(fsm_class=fsm_class, semiring=semiring, start=start,
                  failure_label=failure)
        for _ in range(n_nodes):
            pot, term, n_arcs = struct.unpack_from("<ffI", data, pos)
            pos += 12
            node = FsmNode(potential=pot, term_weight=term)
            for _ in range(n_arcs):
                lf, lt, w, tgt = struct.unpack_from("<IIfI", data, pos)
                pos += 16
                node.arcs.append(Arc(lf, lt, w, tgt))
            fsm.nodes.append(node)
        return fsm

    def save_bin_att(self, path: str) -> None:
        with open(path, "wb") as f:
            if self.failure_label is not None:
                f.write(b"FSM/failure\n")
                f.write(struct.pack("<I", self.failure_label))
            f.write(b"FSM\n")
            f.write(struct.pack("<4I", self.fsm_class, self.semiring,
                                len(self.nodes), self.start))
            for node in self.nodes:
                f.write(struct.pack("<ffI", node.potential,
                                    node.term_weight, len(node.arcs)))
                for a in node.arcs:
                    f.write(struct.pack("<IIfI", a.label_from, a.label_to,
                                        a.weight, a.target))

    # ------------------------------------------------------------------
    @classmethod
    def load_txt_att(cls, path: str) -> "FSM":
        """AT&T text format: `src dst ilabel olabel [weight]` arcs and
        `final [weight]` terminal lines (ids are integers)."""
        fsm = cls()

        def node(i: int) -> int:
            while len(fsm.nodes) <= i:
                fsm.add_node()
            return i

        first = True
        for line in open(path, encoding="latin-1"):
            parts = line.split()
            if not parts:
                continue
            if len(parts) >= 4:
                s, d, il, ol = (int(parts[0]), int(parts[1]),
                                int(parts[2]), int(parts[3]))
                w = float(parts[4]) if len(parts) > 4 else 0.0
                node(max(s, d))
                fsm.add_arc(s, il, ol, w, d)
                if first:
                    fsm.start = s
                    first = False
            else:
                s = int(parts[0])
                w = float(parts[1]) if len(parts) > 1 else 0.0
                fsm.nodes[node(s)].term_weight = w
        return fsm


def compose(A: FSM, B: FSM) -> FSM:
    """Epsilon-aware FST composition (FSM_ALGO::compose, fsm.cpp:923-1101).

    Lazy product construction over a work stack with a composed-node
    index, exactly the reference's expansion order: from state (a, b),
    A's output-eps arcs move a alone, B's input-eps arcs move b alone,
    and a merge-join over (A sorted by labelTo) x (B sorted by labelFrom)
    pairs matching labels.  See the module docstring for the two
    deliberate deviations from the reference (standard label writeback +
    full product on equal-label runs; composed terminal weights).

    Epsilon caveat (inherited from the reference's algorithm): there is
    no epsilon-sequencing filter, so when A has output-eps arcs AND B has
    input-eps arcs from the same composed state, both single-sided moves
    are taken and eps-eps path regions are duplicated.  Path SETS are
    unaffected and tropical weights dedup via min, but log-semiring
    path-sums over such regions are overcounted — use an eps-filter
    composition if that matters.
    """
    if A.semiring != B.semiring:
        raise ValueError("compose requires matching semirings")
    A.sort_arcs("label_to")
    B.sort_arcs("label_from")
    C = FSM(semiring=A.semiring, fsm_class=A.fsm_class)

    index: Dict[Tuple[int, int], int] = {}

    def get_node(a: int, b: int) -> Tuple[int, bool]:
        key = (a, b)
        if key in index:
            return index[key], False
        i = C.add_node()
        index[key] = i
        na, nb = A.nodes[a], B.nodes[b]
        if na.is_terminal and nb.is_terminal:
            C.nodes[i].term_weight = sr_times(
                C.semiring, na.term_weight, nb.term_weight)
        return i, True

    start, _ = get_node(A.start, B.start)
    C.start = start
    stack = [(A.start, B.start)]
    while stack:
        a, b = stack.pop()
        src = index[(a, b)]
        arcs_a = A.nodes[a].arcs
        arcs_b = B.nodes[b].arcs

        def link(ta: int, tb: int, lf: int, lt: int, w: float) -> None:
            dst, fresh = get_node(ta, tb)
            C.add_arc(src, lf, lt, w, dst)
            if fresh:
                stack.append((ta, tb))

        i = 0
        while i < len(arcs_a) and arcs_a[i].label_to == EPS:
            arc = arcs_a[i]
            link(arc.target, b, arc.label_from, EPS, arc.weight)
            i += 1
        j = 0
        while j < len(arcs_b) and arcs_b[j].label_from == EPS:
            arc = arcs_b[j]
            link(a, arc.target, EPS, arc.label_to, arc.weight)
            j += 1
        # merge-join on matching symbols (both lists sorted); pair the
        # full product over equal-label runs
        while i < len(arcs_a) and j < len(arcs_b):
            la, lb = arcs_a[i].label_to, arcs_b[j].label_from
            if la == lb:
                j2 = j
                while j2 < len(arcs_b) and arcs_b[j2].label_from == la:
                    link(arcs_a[i].target, arcs_b[j2].target,
                         arcs_a[i].label_from, arcs_b[j2].label_to,
                         sr_times(C.semiring, arcs_a[i].weight,
                                  arcs_b[j2].weight))
                    j2 += 1
                i += 1
            elif la < lb:
                i += 1
            else:
                j += 1
    return C
