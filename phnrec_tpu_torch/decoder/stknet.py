"""HMM-network Viterbi decoding over STK networks: offline decode and
keyword spotting, and the dense steps that KWS and decode serving need.

Counterpart of phnrec_tpu/decoder/stknet.py.  The reference adapts STKLib's
token-passing engine (stkinterface.{cpp,h} -> STKLib/Viterbi.cc); the
network compiles to dense arrays (``compile_network``, a copy of
phnrec_tpu/decoder/stknet.py:54-298, host numpy), and the per-frame
recursion runs on torch tensors:

  * ``NetworkDecoder``: the compiled network's ``EdgeTables``, the initial
    entry closure, ``state_observations`` (PDFObsVec column gather or DiagC
    GMM log-likelihoods), the edge-list frame scan ``scan_block`` (kernel
    G, ops/netscan.py), the traceback over its records (kernel H,
    ops/nettrace.py), the host walk over stitched streaming records with
    a committed boundary (``traceback_host``, ragged serving sessions),
    the host's label expansion, ``decode`` / ``decode_batch`` and
    ``kws_scan``;
  * ``DenseKWSScan``: the dense max-plus ViterbiStep over [n] streams,
    ``step`` emitting the KWS sink records (its frame loop is kernel B's
    plain version, ops/netstep.py) and ``step_decode`` the edge-list
    scan's traceback records through the edge-id lookups (kernel E's,
    ops/netdecode.py);
  * the LRTrace candidate state machine: on the host (``KWSTracker``,
    ``kws_candidates``, offline KWS), and per frame over streams
    (``lrtrace_init_state``, ``lrtrace_step_fn``), whose frame loop is
    kernel F's plain version (ops/lrtrace.py), with the host decode of its
    flush events;
  * ``StkNetworkDecoder``, the pipeline-facing adapter (decode and KWS
    modes).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from phnrec_tpu_torch.io.labels import Label
from phnrec_tpu_torch.io.mmf import LOG_0, ModelSet
from phnrec_tpu_torch.io.stknet import NetNode, StkNetwork

NEG = np.float32(-1e30)
OFF_BEAM = np.float32(1e30)   # beam width that never prunes (default off)

# ---------------------------------------------------------------------------
# compilation
# ---------------------------------------------------------------------------
@dataclass
class ClosureEdge:
    src: int                 # source model index, or -1 for network START
    dst: int                 # destination model index, or -1 (sink)
    sink: Optional[int]      # sink index when dst == -1
    score: float             # sum of lm*scale + word penalties along path
    words: Tuple[str, ...]   # words crossed, in order
    word_time_reset: bool    # True iff words were crossed (WLR time = now)


@dataclass
class CompiledNetwork:
    # emitting states
    n_states: int
    n_models: int
    obs_index: np.ndarray          # [E] posterior column per state (-1 = GMM)
    gmm_index: np.ndarray          # [E] row into gmm loglik matrix (-1)
    state_model: np.ndarray        # [E] owning model index
    model_names: List[str]
    # within-model + entry edges (targets are emitting states)
    in_src: np.ndarray             # [Ein] source: emitting state id, or
    in_src_is_entry: np.ndarray    # [Ein] bool: src is the model entry slot
    in_dst: np.ndarray             # [Ein]
    in_w: np.ndarray               # [Ein]
    # exit edges (emitting state -> model exit slot)
    ex_src: np.ndarray             # [Eex]
    ex_dst_model: np.ndarray       # [Eex]
    ex_w: np.ndarray               # [Eex]
    # closure edges between models / start / sinks
    closure: List[ClosureEdge]
    # sinks (terminal node + KWS sticky ends)
    sink_names: List[Optional[str]]   # word name or None (null sink)
    terminal_sink: int
    kws_word_sinks: List[int]
    kws_filler_sink: Optional[int]
    gmm_states: List                  # GMMState list for batch eval


def compile_network(net: StkNetwork, models: ModelSet, wpenalty: float,
                    lm_scale: float, mpenalty: float = 0.0,
                    pron_scale: float = 1.0) -> CompiledNetwork:
    model_nodes = [n for n in net.nodes if n.is_model]
    model_index = {id(n): i for i, n in enumerate(model_nodes)}

    # ---- emitting state table
    obs_index: List[int] = []
    gmm_index: List[int] = []
    state_model: List[int] = []
    gmm_states: List = []
    in_src, in_entry, in_dst, in_w = [], [], [], []
    ex_src, ex_dst, ex_w = [], [], []
    state_base: List[int] = []
    for mi, node in enumerate(model_nodes):
        if node.model not in models.hmms:
            raise ValueError(f"model {node.model!r} not in HMM set")
        hmm = models.hmms[node.model]
        N = hmm.n_states
        base = len(obs_index)
        state_base.append(base)
        for j in range(N - 2):
            oc = hmm.obs_coefs[j]
            if oc is not None:
                obs_index.append(oc)
                gmm_index.append(-1)
            else:
                obs_index.append(-1)
                gmm_index.append(len(gmm_states))
                gmm_states.append(hmm.gmm_states[j])
            state_model.append(mi)
        lt = hmm.log_transp
        for j in range(1, N - 1):           # to emitting state j
            if lt[0, j] > LOG_0 / 2:        # entry edge
                in_src.append(mi)
                in_entry.append(True)
                in_dst.append(base + j - 1)
                in_w.append(float(lt[0, j]))
            for i in range(1, N - 1):       # from emitting state i
                if lt[i, j] > LOG_0 / 2:
                    in_src.append(base + i - 1)
                    in_entry.append(False)
                    in_dst.append(base + j - 1)
                    in_w.append(float(lt[i, j]))
        for i in range(1, N - 1):           # exit edges
            if lt[i, N - 1] > LOG_0 / 2:
                ex_src.append(base + i - 1)
                ex_dst.append(mi)
                ex_w.append(float(lt[i, N - 1]))

    # ---- sinks: terminal + sticky non-model nodes
    sink_nodes: List[NetNode] = []
    last = net.last
    if not last.is_model:
        sink_nodes.append(last)
    for n in net.nodes:
        if not n.is_model and n.is_sticky and n is not last:
            sink_nodes.append(n)
    sink_of = {id(n): i for i, n in enumerate(sink_nodes)}

    # ---- closure over instantaneous nodes (nulls, word nodes, and TEE
    # models — models with a direct entry->exit transition, Net.h:33-43,
    # passed through within a frame by Viterbi.cc:1340-1500).
    #
    # Only the BEST-scoring instantaneous path between a (source, target)
    # pair can ever win the runtime max, and closure scores are static,
    # so the walk is single-source max-plus relaxation with per-node
    # memoization and parent backpointers — O(V*E) worst case instead of
    # path enumeration (exponential on diamond null lattices, recursion-
    # depth-bound on deep chains).  Zero/negative-score cycles through
    # null nodes converge (relaxation is strict-improvement only);
    # positive cycles would let a token gain score within one frame and
    # raise, as STK would loop.
    #
    # Tie policy: among EQUAL-score instantaneous paths between the same
    # (source, target), the first-reached path in seed/BFS order wins.
    # This matches STK's strictly-greater token passing in spirit but is
    # not guaranteed to pick the same WORD SEQUENCE as STK's exact
    # active-list order for pathological networks where two equal-score
    # null paths carry different words (no generated phnrec network has
    # such ties; the oracle suites pin the real networks' behavior).
    closure: List[ClosureEdge] = []

    tee_weight: Dict[int, float] = {}
    for mi, node in enumerate(model_nodes):
        lt = models.hmms[node.model].log_transp
        if lt[0, lt.shape[0] - 1] > LOG_0 / 2:
            tee_weight[mi] = float(lt[0, lt.shape[0] - 1])

    node_doc_order = {id(n): i for i, n in enumerate(net.nodes)}

    def emit_closures(src_model: int, seeds) -> None:
        """seeds: [(target_node, arrival_score)] — arcs leaving the
        source with lm like already applied.  Relax to fixpoint, then
        emit one ClosureEdge per reached model entry / sink."""
        from collections import deque

        best: Dict[int, Tuple[float, Optional[int], Optional[str],
                              NetNode]] = {}
        # best[id] = (score, parent_id, word_emitted_at_node, node)
        relax = {}
        work = deque()
        limit = len(net.nodes) + 1

        def arrive(node: NetNode, score: float, parent: Optional[int]
                   ) -> None:
            word = None
            if not node.is_model and node.word is not None:
                score += wpenalty   # + pron_scale * pronprob (0 here)
                word = node.word
            cur = best.get(id(node))
            if cur is not None and score <= cur[0]:
                return              # strict improvement only: ties keep
            relax[id(node)] = relax.get(id(node), 0) + 1
            if relax[id(node)] > limit:
                raise ValueError(
                    "positive-score cycle through instantaneous nodes")
            best[id(node)] = (score, parent, word, node)
            work.append(node)

        for tgt, s in seeds:
            arrive(tgt, s, None)
        while work:
            node = work.popleft()
            score = best[id(node)][0]
            if node.is_model:
                # continue only THROUGH tee models (entry->exit within
                # the frame, + the model penalty applied on exit)
                tw = tee_weight.get(model_index[id(node)])
                if tw is None:
                    continue
                score = score + tw + mpenalty
            for tgt, arc_lm in node.links:
                arrive(tgt, score + arc_lm * lm_scale, id(node))

        def words_of(nid: int) -> Tuple[str, ...]:
            out: List[str] = []
            while nid is not None:
                score, parent, word, _ = best[nid]
                if word is not None:
                    out.append(word)
                nid = parent
            out.reverse()
            return tuple(out)

        # emit in document order of the target (the runtime dense-row
        # argmax resolves ties to the lowest edge id, matching STK's
        # document-order first-wins processing)
        for nid, (score, parent, word, node) in sorted(
                best.items(), key=lambda kv: node_doc_order[kv[0]]):
            words = words_of(nid)
            if node.is_model:
                closure.append(ClosureEdge(
                    src_model, model_index[id(node)], None, score,
                    words, bool(words)))
            elif nid in sink_of:
                # sticky sinks keep propagating within the frame:
                # StkInterface kills their tokens only AFTER the frame
                # (stkinterface.cpp:279); propagation continued above
                closure.append(ClosureEdge(
                    src_model, -1, sink_of[nid], score, words,
                    bool(words)))

    # from network START
    start = net.first
    if start.is_model:
        closure.append(ClosureEdge(-1, model_index[id(start)], None, 0.0,
                                   (), False))
    else:
        emit_closures(-1, [(start, 0.0)])
    # from each model's exit (model exit adds mMPenalty, Viterbi.cc:1406)
    for mi, node in enumerate(model_nodes):
        emit_closures(mi, [(tgt, mpenalty + arc_lm * lm_scale)
                           for tgt, arc_lm in node.links])

    kws_word_sinks = [i for i, n in enumerate(sink_nodes)
                      if n.is_sticky and n.word is not None]
    kws_filler = [i for i, n in enumerate(sink_nodes)
                  if n.is_sticky and n.word is None and n is not net.last]
    # the terminal may itself be the filler end (loop networks reuse it)
    if not kws_filler and sink_nodes and sink_nodes[0].word is None:
        kws_filler = [0]

    return CompiledNetwork(
        n_states=len(obs_index),
        n_models=len(model_nodes),
        obs_index=np.asarray(obs_index, np.int32),
        gmm_index=np.asarray(gmm_index, np.int32),
        state_model=np.asarray(state_model, np.int32),
        model_names=[n.model for n in model_nodes],
        in_src=np.asarray(in_src, np.int32),
        in_src_is_entry=np.asarray(in_entry, bool),
        in_dst=np.asarray(in_dst, np.int32),
        in_w=np.asarray(in_w, np.float32),
        ex_src=np.asarray(ex_src, np.int32),
        ex_dst_model=np.asarray(ex_dst, np.int32),
        ex_w=np.asarray(ex_w, np.float32),
        closure=closure,
        sink_names=[n.word for n in sink_nodes],
        terminal_sink=0 if sink_nodes else -1,
        kws_word_sinks=kws_word_sinks,
        kws_filler_sink=kws_filler[0] if kws_filler else None,
        gmm_states=gmm_states,
    )


# ---------------------------------------------------------------------------
# dense Viterbi scan
# ---------------------------------------------------------------------------
def _device_cache(obj, device, build):
    """``build(device)`` once per device, cached on ``obj``."""
    cache = obj.__dict__.setdefault("_dev_cache", {})
    key = str(torch.device(device))
    if key not in cache:
        cache[key] = build(torch.device(device))
    return cache[key]


def device_rows(v, dtype, device, n: int) -> torch.Tensor:
    """A per-row value as an [n] ``dtype`` tensor on ``device`` without
    waiting for the device's stream: a scalar is filled there, a host
    array or tensor goes through pinned memory by a non-blocking copy (a
    pageable copy would wait for all the work queued before it)."""
    device = torch.device(device)
    if torch.is_tensor(v) and v.device.type != "cpu":
        return v.to(device=device, dtype=dtype).expand(n).contiguous()
    a = v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
    if a.dim() == 0:
        return torch.full((n,), a.item(), dtype=dtype, device=device)
    a = a.to(dtype).expand(n).contiguous()
    if device.type == "cuda":
        return a.pin_memory().to(device, non_blocking=True)
    return a.to(device)


def _dense_in(dst, num: int) -> np.ndarray:
    """For each destination, the ids of the edges feeding it, ascending,
    rows padded with -1 (phnrec_tpu/decoder/stknet.py:340-348).  Ascending
    edge ids + first-max argmax = the first-wins tie-breaking of
    PassTokenMax (Viterbi.cc:1727-1752)."""
    rows: List[List[int]] = [[] for _ in range(num)]
    for k, d in enumerate(np.asarray(dst)):
        rows[int(d)].append(k)
    K = max((len(r) for r in rows), default=1) or 1
    out = np.full((num, K), -1, np.int32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


@dataclass
class EdgeTables:
    """A compiled network's edge lists as the scans read them (int32 ids,
    float32 weights; phnrec_tpu/decoder/stknet.py:309-357): in-model and
    entry edges into the emitting states, exit edges into the models,
    closure edges into model entries (``cm_*``) and into sinks
    (``cs_*``), each with its dense incoming-edge table."""
    n_states: int
    n_models: int
    n_sinks: int
    in_src: np.ndarray          # [Ein] source state, or model (entry)
    in_entry: np.ndarray        # [Ein] bool: the source is a model entry
    in_w: np.ndarray
    in_dense: np.ndarray        # [E, K_in]
    ex_src: np.ndarray          # [Eex] source state
    ex_w: np.ndarray
    ex_dense: np.ndarray        # [M, K_ex]
    cm_src: np.ndarray          # [n_cm] source model, -1 for START
    cm_w: np.ndarray
    cm_reset: np.ndarray        # [n_cm] bool: words crossed (time reset)
    cm_dense: np.ndarray        # [M, K_cm]
    cs_src: np.ndarray          # [n_cs]
    cs_w: np.ndarray
    cs_dense: np.ndarray        # [S, K_cs]; all -1 when n_cs is 0

    def tensors(self, device) -> Dict[str, torch.Tensor]:
        """The tables on ``device``, int32 / float32 / bool, contiguous,
        with the clipped source views the gathers use (``in_src_m``,
        ``in_src_s``) and kernel G's slot tables
        (ops/netscan.slot_arrays)."""
        from phnrec_tpu_torch.ops.netscan import slot_arrays
        M, E = self.n_models, self.n_states
        arrays = {k: getattr(self, k) for k in (
            "in_entry", "in_w", "in_dense", "ex_src", "ex_w", "ex_dense",
            "cm_src", "cm_w", "cm_reset", "cm_dense", "cs_src", "cs_w",
            "cs_dense")}
        arrays["in_src_m"] = np.clip(self.in_src, 0, max(M - 1, 0))
        arrays["in_src_s"] = np.clip(self.in_src, 0, max(E - 1, 0))
        arrays.update(slot_arrays(self))
        return {k: torch.tensor(np.ascontiguousarray(v), device=device)
                for k, v in arrays.items()}


class NetworkDecoder:
    """Viterbi over a compiled network: the edge tables, observation
    lookup, initial carry, the frame scan (kernel G) and the traceback
    (kernel H)."""

    def __init__(self, compiled: CompiledNetwork):
        self.c = c = compiled
        # split closure edges: model->model (graph edges) and ->sink
        self.cm = [e for e in c.closure if e.dst >= 0]
        self.cs = [e for e in c.closure if e.dst < 0]
        self.obs_idx = np.maximum(c.obs_index, 0).astype(np.int64)
        self.n_sinks = len(c.sink_names)
        self._entry0: Dict[str, Tuple[torch.Tensor, ...]] = {}
        i32 = lambda a: np.asarray(a, np.int32)  # noqa: E731
        f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
        cs_dense = (_dense_in([e.sink for e in self.cs], self.n_sinks)
                    if self.cs else np.full((self.n_sinks, 1), -1, np.int32))
        self.tables = EdgeTables(
            n_states=c.n_states, n_models=c.n_models, n_sinks=self.n_sinks,
            in_src=i32(c.in_src), in_entry=np.asarray(c.in_src_is_entry,
                                                      bool),
            in_w=f32(c.in_w), in_dense=_dense_in(c.in_dst, c.n_states),
            ex_src=i32(c.ex_src), ex_w=f32(c.ex_w),
            ex_dense=_dense_in(c.ex_dst_model, c.n_models),
            cm_src=i32([e.src for e in self.cm]),
            cm_w=f32([e.score for e in self.cm]),
            cm_reset=np.asarray([e.word_time_reset for e in self.cm], bool),
            cm_dense=_dense_in([e.dst for e in self.cm], c.n_models),
            cs_src=i32([e.src for e in self.cs]),
            cs_w=f32([e.score for e in self.cs]), cs_dense=cs_dense)

    def edge_tables(self, device) -> Dict[str, torch.Tensor]:
        """``tables`` on ``device``, built once per device."""
        return _device_cache(self.tables, device, self.tables.tensors)

    # -- initial entry values (ViterbiInit: token like 0 in first node,
    #    then one network propagation)
    def _init_entry(self):
        M = self.c.n_models
        entry = np.full(M, NEG, np.float32)
        entry_edge = np.full(M, -1, np.int32)
        entry_wt = np.zeros(M, np.int32)
        for k, e in enumerate(self.cm):
            if e.src == -1 and e.score > entry[e.dst]:
                entry[e.dst] = e.score
                entry_edge[e.dst] = k
        return entry, entry_edge, entry_wt

    def _tables(self, device):
        """Observation-lookup tensors on ``device``, built once: the column
        index per state and, for DiagC GMM states, same-shape states
        stacked into [G, M, D] tensors centred by the group's mean of
        means (phnrec_tpu/decoder/stknet.py:372-401)."""
        def build(dev):
            out = {"obs_idx": torch.tensor(self.obs_idx, device=dev),
                   "gmm": None}
            if not self.c.gmm_states:
                return out
            f32 = lambda a: torch.tensor(  # noqa: E731
                np.asarray(a, np.float32), device=dev)
            by_shape: Dict[Tuple[int, int], List[int]] = {}
            for gi, g in enumerate(self.c.gmm_states):
                by_shape.setdefault(g.means.shape, []).append(gi)
            groups, rows = [], []
            for idxs in by_shape.values():
                gs = [self.c.gmm_states[i] for i in idxs]
                means = np.stack([g.means for g in gs])        # [G, M, D]
                center = means.mean(axis=(0, 1))               # [D]
                groups.append((
                    f32(center), f32(means - center),
                    f32(1.0 / np.stack([g.variances for g in gs])),
                    f32(np.log(np.stack([g.weights for g in gs]))
                        - 0.5 * np.stack([g.gconsts for g in gs]))))
                rows.append(idxs)
            n_gmm = len(self.c.gmm_states)
            perm = np.empty(n_gmm, np.int64)
            perm[np.concatenate(rows)] = np.arange(n_gmm)
            out["gmm"] = groups
            out["perm"] = torch.tensor(perm, device=dev)
            out["is_gmm"] = torch.tensor(self.c.gmm_index >= 0, device=dev)
            out["gidx"] = torch.tensor(
                np.maximum(self.c.gmm_index, 0).astype(np.int64),
                device=dev)
            return out
        return _device_cache(self, device, build)

    def state_observations(self, obs: torch.Tensor) -> torch.Tensor:
        """[..., D] decoder input -> [..., E] per-state observation
        log-probs.  PDFObsVec states gather their posterior column; DiagC
        GMM states get batched log-likelihoods, one quadratic-form einsum
        + logsumexp per distinct (n_mix, dim) shape
        (DiagCGaussianMixtureDensity, Viterbi.cc:719-755)."""
        t = self._tables(obs.device)
        cols = obs[..., t["obs_idx"]]
        if t["gmm"] is None:
            return cols
        parts = []
        for center, means, inv_var, logw_half in t["gmm"]:
            oc = obs - center
            o2 = torch.einsum("...d,gmd->...gm", oc * oc, inv_var)
            om = torch.einsum("...d,gmd->...gm", oc, means * inv_var)
            mm = torch.sum(means * means * inv_var, dim=-1)   # [G, M]
            comp = logw_half - 0.5 * (o2 - 2.0 * om + mm)
            parts.append(torch.logsumexp(comp, dim=-1))
        gll = torch.cat(parts, dim=-1)[..., t["perm"]]
        return torch.where(t["is_gmm"], gll[..., t["gidx"]], cols)

    def init_carry(self, device="cpu", n: Optional[int] = None):
        """Network state after ViterbiInit: empty models, initial entry
        closure applied (stkinterface.cpp:163-211); [E]/[M] leaves, or
        [n, E]/[n, M] for n rows."""
        c = self.c
        key = str(torch.device(device))
        if key not in self._entry0:     # copied to the device once
            self._entry0[key] = tuple(torch.tensor(a, device=device)
                                      for a in self._init_entry())
        entry0, entry_edge0, entry_wt0 = self._entry0[key]
        lead = () if n is None else (n,)

        def rows(t):
            return t.clone() if n is None else t[None].repeat(n, 1)

        return (torch.full((*lead, c.n_states), float(NEG), device=device),
                torch.zeros((*lead, c.n_states), dtype=torch.int32,
                            device=device),
                rows(entry0), rows(entry_edge0), rows(entry_wt0))

    def scan_block(self, carry, obs_state: torch.Tensor, t0, n_valid, beam):
        """Scan a block of frames from an explicit [B]-row carry
        (streaming chunk or whole utterance) through kernel G.
        ``obs_state``: [B, T, E]; ``t0``: [B] frames decoded before the
        block (times are 1-based, so the block covers t0+1..t0+T);
        ``n_valid``: [B] absolute valid frame counts (later frames pass
        the carry through); ``beam``: [B] pruning widths (OFF_BEAM never
        prunes).  Returns (carry', records of [B, T, .])."""
        from phnrec_tpu_torch.ops import netscan
        dev = obs_state.device
        B = obs_state.shape[0]
        return netscan.netscan(
            carry, obs_state.contiguous(),
            device_rows(t0, torch.int32, dev, B),
            device_rows(n_valid, torch.int32, dev, B),
            device_rows(beam, torch.float32, dev, B), self.edge_tables(dev))

    def _scan_batch(self, obs_state: torch.Tensor, n_valid, beam=None):
        """[B, T, E] per-state observations + [B] valid counts -> records
        [B, T, .], one launch of kernel G from the initial carry."""
        beam = OFF_BEAM if beam is None else beam
        B = obs_state.shape[0]
        return self.scan_block(self.init_carry(obs_state.device, B),
                               obs_state, 0, n_valid, beam)[1]

    def _scan(self, obs_state: torch.Tensor, n_valid, beam=None):
        """One utterance: [T, E] -> records [T, .]."""
        recs = self._scan_batch(obs_state[None], n_valid, beam)
        return {k: v[0] for k, v in recs.items()}

    def _run_scan(self, obs: torch.Tensor, beam=None):
        """[T, D] decoder input -> records [T, .] on obs's device.  JAX
        pads T to a compile bucket here (phnrec_tpu/decoder/stknet.py:
        550-561); the port compiles nothing per shape and scans T."""
        return self._scan(self.state_observations(obs), obs.shape[0], beam)

    def _traceback_batch(self, recs, n_valid, frame0=None):
        """Kernel H over [B] rows of records: (ok, sink_edge, sink_val,
        edges [B, T], vals [B, T]).  ``frame0`` (per row, default -1): the
        committed boundary in window-relative frames."""
        from phnrec_tpu_torch.ops import nettrace
        dev = recs["in_am"].device
        B = recs["in_am"].shape[0]
        nv = torch.as_tensor(n_valid, dtype=torch.int32, device=dev)
        f0 = (torch.full((B,), -1, dtype=torch.int32, device=dev)
              if frame0 is None else
              torch.as_tensor(frame0, dtype=torch.int32, device=dev))
        return nettrace.nettrace(recs, nv.contiguous(), f0.contiguous(),
                                 self.edge_tables(dev), self.c.terminal_sink)

    def traceback_host(self, recs, frame_offset: int = 0,
                       boundary: bool = False,
                       like_offset: float = 0.0) -> List[Label]:
        """Host walk over ONE row of (possibly stitched streaming) records,
        numpy arrays [T, .] (phnrec_tpu/decoder/stknet.py:578-655).
        ``frame_offset`` shifts the labels' frames (the records are a
        retained window starting at that absolute frame); ``boundary``
        marks that row 0 is a commit point, not the utterance start — a
        walk reaching it stops there (its words went out with the committed
        prefix), the forced commit of the reference's TimePruning ring
        (Viterbi.cc:65-125); ``like_offset`` is the cumulative path like at
        the window's start."""
        T = recs["in_am"].shape[0]
        c = self.c
        ts = c.terminal_sink
        if ts < 0 or T == 0 or recs["sink_val"][T - 1, ts] <= NEG / 2:
            return []
        # walk back: sink closure edge -> source model's exit -> states
        words: List[Tuple[str, int, float]] = []   # (word, end_t, like)

        def note_words(edge_words, t, like):
            for w in reversed(edge_words):
                words.append((w, t, like))

        cs_edge = self.cs[int(recs["cs_am"][T - 1, ts])]
        note_words(cs_edge.words, T, float(recs["sink_val"][T - 1, ts]))
        model = cs_edge.src
        t = T - 1
        while model >= 0 and t >= 0:
            state = int(c.ex_src[int(recs["ex_am"][t, model])])
            # within the model until an entry edge is taken
            while True:
                k = int(recs["in_am"][t, state])
                if bool(c.in_src_is_entry[k]):
                    m = int(c.in_src[k])
                    # the entry value at frame t came from the closure at
                    # frame t-1 (or the initial closure at t == 0)
                    if t == 0:
                        if not boundary:
                            e = self.cm[int(recs["entry_edge"][0, m])]
                            note_words(e.words, 0,
                                       float(recs["entry_val"][0, m]))
                            model = e.src
                        else:
                            # a commit point: these words are committed
                            model = -1
                        t = -1
                        break
                    e = self.cm[int(recs["cm_am"][t - 1, m])]
                    note_words(e.words, t, float(recs["entry_val"][t, m]))
                    model = e.src
                    t -= 1
                    break
                state = int(c.in_src[k])
                t -= 1
                if t < 0:
                    model = -1
                    break
        words.reverse()
        # record values are cumulative path likes; a retained window starts
        # at the committed path's like, not zero
        labels: List[Label] = []
        prev_t, prev_like = 0, like_offset
        for w, end_t, like in words:
            labels.append(Label(prev_t + frame_offset, end_t + frame_offset,
                                w, like - prev_like))
            prev_t, prev_like = end_t, like
        return labels

    def labels_from_edge_walk(self, ok_b, sink_edge_b, sink_val_b,
                              edges_b, vals_b, n_valid: int,
                              frame_offset: int = 0, frame0_rel: int = 0,
                              like0: float = 0.0) -> List[Label]:
        """Host expansion of ONE row of the traceback's output into word
        labels: crossed closure-edge ids -> word sequences, likes as
        cumulative-path deltas.  ``frame0_rel``/``like0`` seed the first
        label's start frame and like base (the committed boundary);
        ``frame_offset`` shifts window-relative frames to absolute."""
        if not ok_b:
            return []
        words: List[Tuple[str, int, float]] = []
        cs_edge = self.cs[int(sink_edge_b)]
        for w in reversed(cs_edge.words):
            words.append((w, n_valid, float(sink_val_b)))
        ts = np.nonzero(np.asarray(edges_b[:n_valid]) >= 0)[0]
        for t in ts[::-1]:
            e = self.cm[int(edges_b[t])]
            for w in reversed(e.words):
                words.append((w, int(t), float(vals_b[t])))
        words.reverse()
        labels: List[Label] = []
        prev_t, prev_like = frame0_rel, like0
        for w, end_t, like in words:
            labels.append(Label(prev_t + frame_offset,
                                end_t + frame_offset, w, like - prev_like))
            prev_t, prev_like = end_t, like
        return labels

    def decode_batch(self, log_post: torch.Tensor, n_frames,
                     beam=None) -> List[List[Label]]:
        """[B, T, D] log posteriors + [B] frame counts -> per-row word
        labels: kernel G, then kernel H, one launch each, on log_post's
        device, and one fetch of the walks."""
        B = log_post.shape[0]
        if self.c.terminal_sink < 0:
            return [[] for _ in range(B)]
        dev = log_post.device
        nv = device_rows(np.asarray(n_frames, np.int32), torch.int32, dev, B)
        recs = self._scan_batch(self.state_observations(log_post), nv, beam)
        walk = [x.cpu().numpy() for x in self._traceback_batch(recs, nv)]
        n_frames = np.asarray(n_frames)
        return [self.labels_from_edge_walk(*(x[b] for x in walk),
                                           int(n_frames[b]))
                for b in range(B)]

    def decode(self, obs: torch.Tensor, beam=None) -> List[Label]:
        """Full decode: obs [T, D] log posteriors -> word labels (the
        TimePruning + ViterbiDone output), as a batch of one."""
        return self.decode_batch(obs[None], [obs.shape[0]], beam=beam)[0]

    def kws_sinks(self, recs):
        """KWS per-frame values from records [..., T, S]: (word_sink_vals
        [..., T, K], filler_vals [..., T], word_start_times [..., T, K])."""
        c = self.c
        ws = torch.as_tensor(np.asarray(c.kws_word_sinks, np.int64),
                             device=recs["sink_val"].device)
        return (recs["sink_val"][..., ws], recs["sink_val"][
            ..., c.kws_filler_sink], recs["sink_wt"][..., ws])

    def kws_scan(self, obs: torch.Tensor, beam=None):
        """KWS per-frame values of one utterance [T, D]: returns
        (word_sink_vals [T, K], filler_vals [T], word_start_times [T, K])
        as numpy."""
        return tuple(x.cpu().numpy()
                     for x in self.kws_sinks(self._run_scan(obs, beam)))


class DenseKWSScan:
    """Dense max-plus formulation of ViterbiStep for multi-stream KWS
    serving (phnrec_tpu/decoder/stknet.py:810-950).

    Per destination, edge ids ascend with (entry slot, then source state /
    source model), so laying the source axis out as [model entry slots
    (M), then emitting states (E)] makes argmax's first-max-wins pick the
    same winner as the edge-list scan's lowest-edge-id rule.  Parallel
    edges between the same (src, dst) collapse at build time keeping the
    first on ties.  ``step`` emits the sink records (sink_val/sink_wt) the
    KWS tracker consumes; ``step_decode`` the traceback records of the
    edge-list scan, its edge ids through the ``I_*`` lookups (per source
    row and destination, the edge id the edge-list reduction records).
    """

    def __init__(self, decoder: NetworkDecoder):
        c = decoder.c
        M, E = c.n_models, c.n_states
        S = decoder.n_sinks
        A_in = np.full((M + E, E), NEG, np.float32)
        I_in = np.full((M + E, E), -1, np.int32)
        for k in range(len(c.in_src)):
            row = (int(c.in_src[k]) if c.in_src_is_entry[k]
                   else M + int(c.in_src[k]))
            dst, w = int(c.in_dst[k]), np.float32(c.in_w[k])
            if w > A_in[row, dst]:
                A_in[row, dst] = w
                I_in[row, dst] = k
        A_ex = np.full((E, M), NEG, np.float32)
        I_ex = np.full((E, M), -1, np.int32)
        for k in range(len(c.ex_src)):
            src, dst = int(c.ex_src[k]), int(c.ex_dst_model[k])
            w = np.float32(c.ex_w[k])
            if w > A_ex[src, dst]:
                A_ex[src, dst] = w
                I_ex[src, dst] = k
        A_cm = np.full((M, M), NEG, np.float32)
        R_cm = np.zeros((M, M), bool)
        I_cm = np.full((M, M), -1, np.int32)
        for k, e in enumerate(decoder.cm):
            if e.src < 0:
                continue           # START closure: handled by init_carry
            w = np.float32(e.score)
            if w > A_cm[e.src, e.dst]:
                A_cm[e.src, e.dst] = w
                R_cm[e.src, e.dst] = e.word_time_reset
                I_cm[e.src, e.dst] = k
        A_cs = np.full((M, max(S, 1)), NEG, np.float32)
        I_cs = np.full((M, max(S, 1)), -1, np.int32)
        for k, e in enumerate(decoder.cs):
            if e.src < 0:
                continue
            w = np.float32(e.score)
            if w > A_cs[e.src, e.sink]:
                A_cs[e.src, e.sink] = w
                I_cs[e.src, e.sink] = k
        # tie-parity invariant, checked at build (stknet.py:886-901): per
        # destination, edge ids must ascend with source row
        for name, tab in (("in", I_in), ("ex", I_ex), ("cm", I_cm),
                          ("cs", I_cs)):
            for d in range(tab.shape[1]):
                ids = tab[tab[:, d] >= 0, d]
                if not np.all(np.diff(ids) > 0):
                    raise AssertionError(
                        f"dense {name}-table edge ids not ascending with "
                        f"source row for dst {d}: tie-breaking would "
                        "diverge from the edge-list scan")
        entry0, entry_edge0, _ = decoder._init_entry()
        self._set_tables(A_in, A_ex, A_cm, R_cm, A_cs, entry0, S,
                         (I_in, I_ex, I_cm, I_cs), entry_edge0)

    @classmethod
    def from_tables(cls, A_in, A_ex, A_cm, R_cm, A_cs, entry0,
                    n_sinks: int, ids=None,
                    entry_edge0=None) -> "DenseKWSScan":
        """A scan over given tables (convert.py carries phnrec_tpu's).
        ``ids`` = (I_in, I_ex, I_cm, I_cs); without them each live edge
        gets an id that ascends with its source row per destination (the
        tie-parity order), numbered destination by destination, and the
        initial entry edges are -1."""
        self = cls.__new__(cls)
        if ids is None:
            ids = tuple(_canonical_ids(a) for a in (A_in, A_ex, A_cm, A_cs))
        if entry_edge0 is None:
            entry_edge0 = np.full(np.shape(entry0), -1, np.int32)
        self._set_tables(A_in, A_ex, A_cm, R_cm, A_cs, entry0, n_sinks, ids,
                         entry_edge0)
        return self

    def _set_tables(self, A_in, A_ex, A_cm, R_cm, A_cs, entry0,
                    n_sinks: int, ids, entry_edge0) -> None:
        self.A_in = np.asarray(A_in, np.float32)      # [M+E, E]
        self.A_ex = np.asarray(A_ex, np.float32)      # [E, M]
        self.A_cm = np.asarray(A_cm, np.float32)      # [M, M]
        self.R_cm = np.asarray(R_cm, bool)            # [M, M]
        self.A_cs = np.asarray(A_cs, np.float32)      # [M, max(S, 1)]
        self._entry0 = np.asarray(entry0, np.float32)
        # the edge ids beside the weights, -1 where no edge
        self.I_in, self.I_ex, self.I_cm, self.I_cs = (
            np.asarray(i, np.int32) for i in ids)
        self._entry_edge0 = np.asarray(entry_edge0, np.int32)
        self.E = self.A_in.shape[1]
        self.M = self.A_in.shape[0] - self.E
        self.n_sinks = n_sinks

    def tables(self, device):
        """The weight and id tables as tensors on ``device`` (cached)."""
        return _device_cache(self, device, lambda d: {
            k: torch.tensor(getattr(self, k), device=d)
            for k in ("A_in", "A_ex", "A_cm", "R_cm", "A_cs", "_entry0",
                      "I_in", "I_ex", "I_cm", "I_cs", "_entry_edge0")})

    def init_carry(self, n: int, device="cpu"):
        """[n]-stream carry: (alpha [n,E], wt [n,E], entry [n,M],
        entry_wt [n,M]) — ViterbiInit + the initial entry closure."""
        t = self.tables(device)
        return (torch.full((n, self.E), float(NEG), device=device),
                torch.zeros((n, self.E), dtype=torch.int32, device=device),
                t["_entry0"][None].repeat(n, 1),
                torch.zeros((n, self.M), dtype=torch.int32, device=device))

    def step(self, carry, obs_t, t, live, beam):
        """One ViterbiStep over [n] streams: obs_t [n, E], t [n] global
        1-based frame times (int32), live [n] row mask, beam [n] per-stream
        pruning widths.  Returns (carry', (sink_val [n, S], sink_wt
        [n, S])).  Maxima are exact and argmaxes first-index, as in JAX."""
        tb = self.tables(obs_t.device)
        alpha, wt, entry, entry_wt = carry
        src = torch.cat([entry, alpha], dim=1)               # [n, M+E]
        s1 = src[:, :, None] + tb["A_in"][None]              # [n, M+E, E]
        new_alpha = torch.amax(s1, dim=1) + obs_t
        am1 = torch.argmax(s1, dim=1)
        src_wt = torch.cat([entry_wt, wt], dim=1)
        new_wt = torch.gather(src_wt, 1, am1)
        thresh = torch.amax(new_alpha, dim=1, keepdim=True) \
            - beam.reshape(-1, 1)
        new_alpha = torch.where(new_alpha >= thresh, new_alpha, float(NEG))
        s2 = new_alpha[:, :, None] + tb["A_ex"][None]        # [n, E, M]
        exit_val = torch.amax(s2, dim=1)
        exit_wt = torch.gather(new_wt, 1, torch.argmax(s2, dim=1))
        s3 = exit_val[:, :, None] + tb["A_cm"][None]         # [n, M, M]
        nentry = torch.amax(s3, dim=1)
        am3 = torch.argmax(s3, dim=1)
        nentry = torch.where(nentry >= thresh, nentry, float(NEG))
        reset = tb["R_cm"][am3, torch.arange(self.M, device=am3.device)]
        nentry_wt = torch.where(reset, t[:, None].to(torch.int32),
                                torch.gather(exit_wt, 1, am3))
        s4 = exit_val[:, :, None] + tb["A_cs"][None]         # [n, M, S]
        sink_val = torch.amax(s4, dim=1)
        sink_wt = torch.gather(exit_wt, 1, torch.argmax(s4, dim=1))
        new = (new_alpha, new_wt, nentry, nentry_wt)
        lv = live[:, None]
        carry = tuple(torch.where(lv, n_, o_) for n_, o_ in zip(new, carry))
        return carry, (sink_val, sink_wt)

    # -- decode-mode dense step (emits traceback records) ---------------
    def init_carry_decode(self, n: int, device="cpu"):
        """[n]-stream decode carry: (alpha [n,E], entry [n,M], entry_edge
        [n,M] i32) — no word-time lanes (the decode traceback takes its
        times from the records)."""
        t = self.tables(device)
        return (torch.full((n, self.E), float(NEG), device=device),
                t["_entry0"][None].repeat(n, 1),
                t["_entry_edge0"][None].repeat(n, 1))

    def step_decode(self, carry, obs_t, live, beam, values: bool = False):
        """One ViterbiStep over [n] streams emitting the traceback records
        of the edge-list scan (phnrec_tpu/decoder/stknet.py:961-996):
        obs_t [n, E], live [n] row mask, beam [n].  Returns (carry', rec
        dict of [n, .]: in_am [E], ex_am, cm_am, entry_edge [M] i32,
        entry_val [M], sink_val [S] f32, cs_am [S] i32); ``values`` adds
        the step's beamed alpha [E], exit values and new entries [M] (what
        the ids' liveness is read from)."""
        tb = self.tables(obs_t.device)
        alpha, entry, entry_edge = carry
        M, E, S = self.M, self.E, self.n_sinks
        dev = obs_t.device
        src = torch.cat([entry, alpha], dim=1)               # [n, M+E]
        s1 = src[:, :, None] + tb["A_in"][None]              # [n, M+E, E]
        new_alpha = torch.amax(s1, dim=1) + obs_t
        in_am = tb["I_in"][torch.argmax(s1, dim=1),
                           torch.arange(E, device=dev)]
        thresh = torch.amax(new_alpha, dim=1, keepdim=True) \
            - beam.reshape(-1, 1)
        new_alpha = torch.where(new_alpha >= thresh, new_alpha, float(NEG))
        s2 = new_alpha[:, :, None] + tb["A_ex"][None]        # [n, E, M]
        exit_val = torch.amax(s2, dim=1)
        ar_m = torch.arange(M, device=dev)
        ex_am = tb["I_ex"][torch.argmax(s2, dim=1), ar_m]
        s3 = exit_val[:, :, None] + tb["A_cm"][None]         # [n, M, M]
        nentry = torch.amax(s3, dim=1)
        cm_am = tb["I_cm"][torch.argmax(s3, dim=1), ar_m]
        nentry = torch.where(nentry >= thresh, nentry, float(NEG))
        s4 = exit_val[:, :, None] + tb["A_cs"][None]         # [n, M, S]
        sink_val = torch.amax(s4, dim=1)[:, :S]
        cs_am = tb["I_cs"][torch.argmax(s4, dim=1)[:, :S],
                           torch.arange(S, device=dev)]
        rec = dict(in_am=in_am, ex_am=ex_am, cm_am=cm_am,
                   entry_edge=entry_edge, entry_val=entry,
                   sink_val=sink_val, cs_am=cs_am)
        if values:
            rec.update(alpha=new_alpha, exit_val=exit_val, nentry=nentry)
        new = (new_alpha, nentry, cm_am)
        lv = live[:, None]
        carry = tuple(torch.where(lv, n_, o_) for n_, o_ in zip(new, carry))
        return carry, rec


def _canonical_ids(A) -> np.ndarray:
    """Ids for the live entries (> NEG / 2) of a dense [src, dst] table,
    numbered destination by destination with sources ascending; -1
    elsewhere."""
    A = np.asarray(A)
    live = A.T > NEG / 2                                 # [dst, src]
    ids = np.where(live, np.cumsum(live.reshape(-1)).reshape(live.shape)
                   - 1, -1)
    return ids.T.astype(np.int32)


@dataclass
class KWSHit:
    word: str
    start: int
    end: int
    score: float
    new_estim: bool = False   # DECMSG_NEWESTIM re-emission (improveKwdEstim)


class KWSTracker:
    """The LRTrace candidate state machine (stkinterface.cpp:240-289,
    349-380) with carried state, vectorized across keywords, on the host
    (copy of phnrec_tpu/decoder/stknet.py:1008-1100): per keyword, track
    the likelihood ratio word_end - filler_end; a candidate grows while the
    LR is non-decreasing; a hypothesis with a later start time than the
    candidate's end flushes the candidate.  ``feed`` consumes any number
    of frames and returns the hits flushed during those frames."""

    def __init__(self, keywords: Sequence[str],
                 time_pruning: float = 1e9,
                 score_pruning: float = -np.inf,
                 improve_kwd_estim: bool = False,
                 keyword0_time_quirk: bool = True):
        self.keywords = list(keywords)
        self.time_pruning = time_pruning
        self.score_pruning = score_pruning   # kwsScorePruning (LR floor)
        # improveKwdEstim (stkinterface.cpp:350-353): an already-dumped
        # candidate whose end time moved is re-emitted as DECMSG_NEWESTIM
        self.improve_kwd_estim = improve_kwd_estim
        # the reference's time-pruned flush tests KEYWORD 0's candidate
        # age for every keyword (stkinterface.cpp:285-288, kept by default)
        self.keyword0_time_quirk = keyword0_time_quirk
        K = len(keywords)
        self.t = 0                            # frames consumed so far
        self.last_lr = np.full(K, -np.inf)
        self.cand_lr = np.full(K, -np.inf)
        self.cand_start = np.zeros(K, np.int64)
        self.cand_end = np.zeros(K, np.int64)
        self.prev_end = np.zeros(K, np.int64)
        self.dumped = np.zeros(K, bool)
        self.hits: List[KWSHit] = []

    def _flush(self, j: int) -> None:
        """PutKWSCandidateToLabels (stkinterface.cpp:349-377): emit when a
        candidate exists and is undumped (or improved); ``dumped`` is set
        only on emission, exactly as the reference does."""
        improved = (self.improve_kwd_estim and
                    self.cand_end[j] != self.prev_end[j])
        if self.cand_end[j] != 0 and (not self.dumped[j] or improved):
            if self.cand_lr[j] >= self.score_pruning:
                self.hits.append(KWSHit(self.keywords[j],
                                        int(self.cand_start[j]),
                                        int(self.cand_end[j]),
                                        float(self.cand_lr[j]),
                                        new_estim=bool(self.dumped[j])))
            self.prev_end[j] = self.cand_end[j]
            self.dumped[j] = True

    def feed(self, word_vals: np.ndarray, filler: np.ndarray,
             start_times: np.ndarray) -> List[KWSHit]:
        """[F, K] word-end values, [F] filler values, [F, K] word start
        times (absolute frames) -> hits flushed during these frames."""
        first = len(self.hits)
        F, K = word_vals.shape
        for i in range(F):
            t = self.t + i
            active = (word_vals[i] > NEG / 2) & (filler[i] > NEG / 2)
            lr = np.where(active, word_vals[i] - filler[i], -np.inf)
            growing = active & (lr >= self.last_lr)
            ws = start_times[i].astype(np.int64)
            new_hyp = growing & (self.cand_end <= ws)
            take = growing & ((lr >= self.cand_lr) | new_hyp)
            for j in np.nonzero(new_hyp & take)[0]:
                self._flush(int(j))
                self.dumped[j] = False
            self.cand_start = np.where(take, ws, self.cand_start)
            self.cand_end = np.where(take, t + 1, self.cand_end)
            self.cand_lr = np.where(take, lr, self.cand_lr)
            self.last_lr = np.where(active, lr, -np.inf)
            if self.time_pruning < 1e9:
                ref_end = (np.full_like(self.cand_end, self.cand_end[0])
                           if self.keyword0_time_quirk else self.cand_end)
                stale = active & (ref_end != 0) & (
                    (t + 1) - ref_end >= self.time_pruning)
                # _flush decides dumped/improved (the reference calls
                # PutKWSCandidateToLabels unconditionally here)
                for j in np.nonzero(stale)[0]:
                    self._flush(int(j))
        self.t += F
        return self.hits[first:]

    def finish(self) -> List[KWSHit]:
        """Flush every outstanding candidate (StkInterface::Done)."""
        first = len(self.hits)
        for j in range(len(self.keywords)):
            self._flush(j)
        return self.hits[first:]


def kws_candidates(word_vals: np.ndarray, filler: np.ndarray,
                   start_times: np.ndarray, keywords: Sequence[str],
                   time_pruning: float = 1e9,
                   score_pruning: float = -np.inf) -> List[KWSHit]:
    """Whole-utterance KWS: feed all frames through a tracker + final
    flush (the streaming emission's state machine), hits sorted by
    (start, end, word)."""
    tr = KWSTracker(keywords, time_pruning, score_pruning)
    tr.feed(word_vals, filler, start_times)
    tr.finish()
    return sorted(tr.hits, key=lambda h: (h.start, h.end, h.word))


def lrtrace_init_state(n_keywords: int, n_streams: Optional[int] = None,
                       device="cpu"):
    """Zero state for the LRTrace scan: six [K] lanes, or [n_streams, K]
    (last_lr, cand_lr f32; cand_start, cand_end, prev_end i32; dumped
    bool)."""
    shape = ((n_keywords,) if n_streams is None
             else (n_streams, n_keywords))
    i32 = dict(dtype=torch.int32, device=device)
    return (torch.full(shape, -float("inf"), device=device),   # last_lr
            torch.full(shape, -float("inf"), device=device),   # cand_lr
            torch.zeros(shape, **i32),                         # cand_start
            torch.zeros(shape, **i32),                         # cand_end
            torch.zeros(shape, **i32),                         # prev_end
            torch.zeros(shape, dtype=torch.bool, device=device))  # dumped


def lrtrace_step_fn(time_pruning: float, score_pruning: float,
                    improve_kwd_estim: bool = False,
                    keyword0_time_quirk: bool = True):
    """Per-frame LRTrace transition (stkinterface.cpp:240-289, 349-380)
    over [..., K] keyword lanes (phnrec_tpu/decoder/stknet.py:1114-1177,
    batched over leading stream axes instead of vmapped).  The serving
    defaults are improveKwdEstim off and keyword 0's quirk on; with
    ``improve_kwd_estim`` a dumped candidate whose end moved since its
    last flush (``cand_end != prev_end``) flushes again, and without
    ``keyword0_time_quirk`` each keyword's time pruning reads its own
    candidate end instead of keyword 0's.  ``inputs`` = (word_vals
    [..., K], filler [...], word_starts [..., K] i32, t [...] i32, live
    [...] bool) — a dead frame passes the state through and emits nothing.
    Emits two flush-event slots per frame (new-hypothesis flush, then the
    time-pruning flush), in the reference's callback order."""
    tp = float(time_pruning)
    sp = float(np.float32(score_pruning))
    improve = bool(improve_kwd_estim)
    quirk = bool(keyword0_time_quirk)

    def flush(cand_lr, cand_start, cand_end, prev_end, dumped, cond):
        undumped = ~dumped
        if improve:
            undumped = undumped | (cand_end != prev_end)
        do = cond & (cand_end != 0) & undumped
        emit = do & (cand_lr >= sp)
        rec = dict(emit=emit, start=cand_start, end=cand_end,
                   score=cand_lr, new_estim=dumped)
        prev_end = torch.where(do, cand_end, prev_end)
        dumped = dumped | do
        return rec, prev_end, dumped

    def step(st, inputs):
        last_lr, cand_lr, cand_start, cand_end, prev_end, dumped = st
        wv, fl, ws, t, live = inputs
        fl = fl[..., None]
        t = t[..., None]
        active = (wv > NEG / 2) & (fl > NEG / 2)
        lr = torch.where(active, wv - fl, -float("inf"))
        growing = active & (lr >= last_lr)
        new_hyp = growing & (cand_end <= ws)
        take = growing & ((lr >= cand_lr) | new_hyp)
        ev1 = new_hyp & take
        rec1, prev_end, dumped = flush(
            cand_lr, cand_start, cand_end, prev_end, dumped, ev1)
        dumped = dumped & ~ev1
        cand_start = torch.where(take, ws, cand_start)
        cand_end = torch.where(take, t + 1, cand_end)
        cand_lr = torch.where(take, lr, cand_lr)
        last_lr = torch.where(active, lr, -float("inf"))
        if tp < 1e9:
            # the reference tests KEYWORD 0's candidate age for every
            # keyword (stkinterface.cpp:285-288, kept by default)
            ref_end = (cand_end[..., :1].expand_as(cand_end) if quirk
                       else cand_end)
            stale = active & (ref_end != 0) & \
                ((t + 1) - ref_end >= int(tp))
            rec2, prev_end, dumped = flush(
                cand_lr, cand_start, cand_end, prev_end, dumped, stale)
        else:
            rec2 = {k: torch.zeros_like(v) for k, v in rec1.items()}
        new = (last_lr, cand_lr, cand_start, cand_end, prev_end, dumped)
        lv = live[..., None]
        st = tuple(torch.where(lv, n_, o_) for n_, o_ in zip(new, st))
        rec1 = dict(rec1, emit=rec1["emit"] & lv)
        rec2 = dict(rec2, emit=rec2["emit"] & lv)
        return st, (rec1, rec2)

    return step


def flush_outstanding_candidates(state_np, keywords,
                                 score_pruning: float) -> List[KWSHit]:
    """StkInterface::Done's final candidate flush from a fetched LRTrace
    state tuple ([K]-shaped leaves, one stream): emit each undumped
    candidate that clears the kwsScorePruning floor, in keyword order
    (mirrors KWSTracker._flush with improve_kwd_estim final semantics)."""
    (_, cand_lr, cand_start, cand_end, _, dumped) = state_np
    hits: List[KWSHit] = []
    for j in range(len(keywords)):
        if cand_end[j] != 0 and not dumped[j] \
                and cand_lr[j] >= score_pruning:
            hits.append(KWSHit(keywords[j], int(cand_start[j]),
                               int(cand_end[j]), float(cand_lr[j])))
    return hits


def decode_lrtrace_events(events_np, keywords) -> List[KWSHit]:
    """Host decode of fetched flush-event records for ONE stream:
    (rec1, rec2) dicts of [F, K] arrays -> hits in the reference's
    callback order (frame-major, new-hyp slot before time-prune slot)."""
    rec1, rec2 = events_np
    emit = np.stack([np.asarray(rec1["emit"]),
                     np.asarray(rec2["emit"])], axis=1)     # [F, 2, K]
    hits: List[KWSHit] = []
    if not emit.any():
        return hits
    recs = [rec1, rec2]
    for t, slot, j in zip(*np.nonzero(emit)):
        r = recs[slot]
        hits.append(KWSHit(
            keywords[j],
            int(np.asarray(r["start"])[t, j]),
            int(np.asarray(r["end"])[t, j]),
            float(np.asarray(r["score"])[t, j]),
            new_estim=bool(np.asarray(r["new_estim"])[t, j])))
    return hits


class DeviceKWSTracker:
    """LRTrace candidate tracking of one stream, its state carried on
    ``device``, the card unless the caller asks for the CPU, as
    phnrec_tpu's runs on the default device
    (phnrec_tpu/decoder/stknet.py:1218-1324, the state
    machine of stkinterface.cpp:240-289/349-380): each block of sink
    records runs through ``ops.lrtrace.lrtrace_scan`` at n = 1, which on
    CUDA tensors launches kernel F and nothing else, and on CPU tensors
    runs F's plain version.  Only the flush-event records leave the
    device, and only when the host asks (``collect``): in the reference's
    callback order, frame-major, the new-hypothesis slot before the
    time-pruning slot."""

    def __init__(self, keywords: Sequence[str],
                 time_pruning: float = 1e9,
                 score_pruning: float = -np.inf,
                 improve_kwd_estim: bool = False,
                 keyword0_time_quirk: bool = True,
                 word_sinks: Optional[Sequence[int]] = None,
                 filler_sink: Optional[int] = None, device="cuda"):
        self.keywords = list(keywords)
        self.hits: List[KWSHit] = []
        self.t = 0
        self.device = torch.device(device)
        self.time_pruning = float(time_pruning)
        self.score_pruning = float(score_pruning)
        self.improve_kwd_estim = bool(improve_kwd_estim)
        self.keyword0_time_quirk = bool(keyword0_time_quirk)
        self._ws = (None if word_sinks is None else torch.tensor(
            np.asarray(word_sinks, np.int32), device=self.device))
        self._fs = filler_sink
        self._pending: List = []
        self._finished = False
        self.state = lrtrace_init_state(len(self.keywords), 1, self.device)

    def _scan(self, sink_val: torch.Tensor, sink_wt: torch.Tensor,
              ws: torch.Tensor, fs: int) -> None:
        from phnrec_tpu_torch.ops import lrtrace
        F = sink_val.shape[0]
        rows = lambda v: torch.tensor([v], dtype=torch.int32,  # noqa: E731
                                      device=sink_val.device)
        self.state, events = lrtrace.lrtrace_scan(
            self.state, sink_val.reshape(F, 1, -1).contiguous(),
            sink_wt.reshape(F, 1, -1).to(torch.int32).contiguous(), ws, fs,
            rows(self.t), rows(F), self.time_pruning, self.score_pruning,
            self.improve_kwd_estim, self.keyword0_time_quirk)
        self.t += F
        self._pending.append(events)

    def feed_sinks(self, sink_val: torch.Tensor,
                   sink_wt: torch.Tensor) -> None:
        """Track a block straight from the decoder's sink records [F,
        n_sinks] (values, word times), on the device they lie on: the
        kernel gathers the word and filler columns itself."""
        if self._ws is None:
            raise ValueError("feed_sinks needs word_sinks and filler_sink")
        self._scan(sink_val, sink_wt, self._ws, self._fs)

    def feed_device(self, word_vals: torch.Tensor, filler: torch.Tensor,
                    start_times: torch.Tensor) -> None:
        """Track a block of given word values [F, K], filler values [F]
        and word start times [F, K] (no host transfer)."""
        K = word_vals.shape[1]
        dev = word_vals.device
        sv = torch.cat([word_vals, filler[:, None]], dim=1)
        sw = torch.cat([start_times.to(torch.int32),
                        torch.zeros_like(start_times[:, :1],
                                         dtype=torch.int32)], dim=1)
        ws = torch.arange(K, dtype=torch.int32, device=dev)
        self._scan(sv, sw, ws, K)

    def collect(self) -> List[KWSHit]:
        """Fetch the pending flush events and append the decoded hits."""
        if not self._pending:
            return []
        fetched = [tuple({k: v[0].cpu().numpy() for k, v in rec.items()}
                         for rec in events) for events in self._pending]
        self._pending = []
        first = len(self.hits)
        for events in fetched:
            self.hits.extend(decode_lrtrace_events(events, self.keywords))
        return self.hits[first:]

    def finish(self) -> List[KWSHit]:
        """Flush every outstanding candidate (StkInterface::Done), from
        one fetch of the carried state.  Idempotent: a second finish()
        adds nothing."""
        first = len(self.hits)
        self.collect()
        if not self._finished:
            self._finished = True
            self.hits.extend(flush_outstanding_candidates(
                tuple(x[0].cpu().numpy() for x in self.state),
                self.keywords, self.score_pruning))
        return self.hits[first:]


class StkNetworkDecoder:
    """Pipeline-facing adapter (the StkInterface equivalent): owns the
    parsed HMM set + network and the engine knobs."""

    def __init__(self, model_set: ModelSet, network: StkNetwork,
                 wpenalty: float, lm_scale: float, mode: str = "decode",
                 time_pruning: int = 40,
                 keyword_thresholds=None,
                 beam_pruning: Optional[float] = None,
                 kws_score_pruning: float = -np.inf, device="cuda"):
        self.model_set = model_set
        self.device = device     # where array inputs are decoded
        self.network = network
        self.lm_scale = lm_scale
        self.mode = mode
        self.time_pruning = time_pruning
        self.keyword_thresholds = keyword_thresholds
        # stkinterface.h:107-113 knob surface: beamPruning (width against
        # the best token like; off by default as in stkinterface.cpp:26)
        # and kwsScorePruning (candidate LR floor)
        self.beam_pruning = beam_pruning
        self.kws_score_pruning = kws_score_pruning
        self._build(wpenalty)

    def _build(self, wpenalty: float) -> None:
        self.wpenalty = wpenalty
        self.compiled = compile_network(self.network, self.model_set,
                                        wpenalty, self.lm_scale)
        self.decoder = NetworkDecoder(self.compiled)

    def set_wpenalty(self, wpenalty: float) -> None:
        self._build(wpenalty)

    # SetBeamPruning / SetKwsScorePruning / SetTimePruning
    # (stkinterface.h:107-113)
    def set_beam_pruning(self, v: Optional[float]) -> None:
        self.beam_pruning = v

    def set_kws_score_pruning(self, v: float) -> None:
        self.kws_score_pruning = v

    def set_time_pruning(self, v: int) -> None:
        self.time_pruning = v

    def keywords(self) -> List[str]:
        return [self.compiled.sink_names[s]
                for s in self.compiled.kws_word_sinks]

    def _xform(self, log_post: torch.Tensor) -> torch.Tensor:
        """The global <InputXform> on [..., T, D] observations before
        scoring (ModelSet::UpdateStacks per ViterbiStep, Viterbi.cc:2068;
        here whole utterances at once)."""
        if self.model_set.input_xform is not None:
            from phnrec_tpu_torch.io.xform import apply_instance
            log_post = apply_instance(self.model_set.input_xform, log_post)
        return log_post

    def _as_tensor(self, log_post) -> torch.Tensor:
        if isinstance(log_post, torch.Tensor):
            return log_post
        return torch.as_tensor(np.asarray(log_post, np.float32),
                               device=self.device)

    def _kws_labels(self, wv, fv, st) -> List[Label]:
        hits = kws_candidates(wv, fv, st, self.keywords(),
                              self.time_pruning, self.kws_score_pruning)
        # thresholds filter only the LIVE callback output in the reference
        # (phnrec.cpp:81-83); label files keep every candidate
        # (PutKWSCandidateToLabels)
        return [Label(h.start, h.end, h.word, h.score) for h in hits]

    def decode(self, log_post) -> List[Label]:
        """One utterance [T, D] (a tensor, on its device, or an array, on
        ``self.device``) -> word labels (decode mode) or keyword hits (KWS
        mode)."""
        lp = self._as_tensor(log_post)
        return self.decode_batch(lp[None], [lp.shape[0]])[0]

    def decode_batch(self, log_post, n_frames) -> List[List[Label]]:
        """[B, T, D] + [B] -> per-row labels: one launch of kernel G over
        the batch (each row's valid count its own), then in decode mode
        one launch of kernel H and the host's label expansion, in KWS mode
        the host tracker per row.  JAX's KWS mode decodes row by row
        (phnrec_tpu/decoder/stknet.py:1416-1419); the rows of a scan are
        independent and frames past a row's count never reach its valid
        frames, so the records and the hits are the same.  The global
        <InputXform> is applied here, once."""
        lp = self._xform(self._as_tensor(log_post))
        dec = self.decoder
        if self.mode != "kws":
            return dec.decode_batch(lp, n_frames, beam=self.beam_pruning)
        n_frames = np.asarray(n_frames)
        nv = torch.as_tensor(n_frames.astype(np.int32), device=lp.device)
        recs = dec._scan_batch(dec.state_observations(lp), nv,
                               self.beam_pruning)
        wv, fv, st = (x.cpu().numpy() for x in dec.kws_sinks(recs))
        return [self._kws_labels(wv[b, :n], fv[b, :n], st[b, :n])
                for b, n in enumerate(n_frames.tolist())]

    @classmethod
    def from_config(cls, sr, cfg) -> "StkNetworkDecoder":
        from phnrec_tpu_torch.io.mmf import parse_mmf
        from phnrec_tpu_torch.io.stknet import parse_stk_network
        from phnrec_tpu_torch.netgen import generate_resources

        generate_resources(cfg)
        ms = parse_mmf(cfg.get_str("models", "hmm_defs"))
        net = parse_stk_network(cfg.get_str("networks", "default"))
        mode = cfg.get_str("decoder", "mode")
        thr = None
        if mode == "kws":
            from phnrec_tpu_torch.kws import Thresholds
            thr = Thresholds.from_config(cfg)
        # beam_pruning/kws_score_pruning: the optional decoder/beam_pruning
        # + kws/score_pruning config extension (stkinterface.h:107-113)
        b = cfg.get_float("decoder", "beam_pruning")
        beam = b if b > 0 else None
        ksp = cfg.get_float("kws", "score_pruning")
        return cls(ms, net,
                   wpenalty=cfg.get_float("decoder", "wpenalty"),
                   lm_scale=cfg.get_float("decoder", "lm_scale"),
                   mode=mode,
                   time_pruning=cfg.get_int("decoder", "time_pruning"),
                   keyword_thresholds=thr,
                   beam_pruning=beam,
                   kws_score_pruning=ksp, device=sr.device)
