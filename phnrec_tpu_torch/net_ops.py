"""Network/lattice surgery — the Net.cc toolbox of the bundled STK.

Copy of phnrec_tpu/net_ops.py on the port's io/stknet.py types.  These
are pure graph algorithms that run once at network-build time on the host
(STK runs them inside ReadSTKNetwork's expansion pipeline, Net_IO.cc; the
results feed the network decoder in decoder/stknet.py).  Implemented
equivalents:

  * remove_null_nodes            — RemoveRedundantNullNodes (Net.cc)
  * self_links_to_null_nodes     — SelfLinksToNullNodes (Net.cc:1537+)
  * expand_by_dictionary         — ExpandWordNetworkByDictionary
                                   (Net.cc:142+): word nodes -> parallel
                                   pronunciation-variant phone chains
  * expand_to_triphones          — ExpandMonophoneNetworkToTriphoneNetwork
                                   (Net.cc:324+): context-dependent
                                   renaming with node splitting per left
                                   context; context-independent phones
                                   break contexts (sil etc.)
  * lattice_local_optimization   — LatticeLocalOptimization (Net.cc:633+):
                                   iterated forward/backward merging of
                                   equivalent nodes

All functions take and return StkNetwork (io/stknet.py) and keep node
`order` fields consistent (renumbered in document order).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

from phnrec_tpu_torch.io.stknet import NT_MODEL, NT_STICKY, NT_WORD, NetNode, \
    StkNetwork


def _renumber(nodes: List[NetNode]) -> StkNetwork:
    for i, n in enumerate(nodes):
        n.order = i
    return StkNetwork(nodes=nodes)


def _backlinks(nodes: Sequence[NetNode]) -> Dict[int, List[Tuple[NetNode,
                                                                 float]]]:
    back: Dict[int, List[Tuple[NetNode, float]]] = {id(n): [] for n in nodes}
    for n in nodes:
        for tgt, like in n.links:
            back[id(tgt)].append((n, like))
    return back


def remove_null_nodes(net: StkNetwork) -> StkNetwork:
    """Bypass interior !NULL word nodes: every predecessor links directly
    to every successor with summed LM log-likes.  First/last nodes and
    sticky nodes are kept (they carry decoder semantics — KWS end nodes)."""
    nodes = list(net.nodes)
    first, last = net.first, net.last
    back = _backlinks(nodes)
    for n in list(nodes):
        if not n.is_null or n is first or n is last or n.is_sticky:
            continue
        preds = back[id(n)]
        succs = n.links
        if not preds or not succs:
            continue
        if any(tgt is n for tgt, _ in n.links):
            continue                          # self-loop: not redundant
        for p, pl in preds:
            p.links = [(t, l) for t, l in p.links if t is not n]
            existing = {id(t) for t, _ in p.links}
            for s, sl in succs:
                if id(s) not in existing:
                    p.links.append((s, pl + sl))
                    back[id(s)].append((p, pl + sl))
        back[id(n)] = []
        nodes.remove(n)
    return _renumber(nodes)


def self_links_to_null_nodes(net: StkNetwork) -> StkNetwork:
    """Replace self-loop arcs n->n with n -> new !NULL -> n (the decoder's
    token pass forbids direct self-arcs on nodes; SelfLinksToNullNodes)."""
    nodes = list(net.nodes)
    out: List[NetNode] = []
    for n in nodes:
        out.append(n)
        self_arcs = [(t, l) for t, l in n.links if t is n]
        if not self_arcs:
            continue
        null = NetNode(ident=f"{n.ident}#self", order=0, ntype=NT_WORD,
                       word=None)
        null.links = [(n, 0.0)]
        n.links = [(t, l) for t, l in n.links if t is not n]
        n.links.append((null, self_arcs[0][1]))
        out.append(null)
    return _renumber(out)


def expand_by_dictionary(net: StkNetwork,
                         dictionary: Dict[str, List[Tuple[List[str], float]]],
                         keep_word_nodes: bool = True,
                         multiple_pronun: bool = True) -> StkNetwork:
    """Replace every word node with its pronunciation variants as chains
    of model nodes (ExpandWordNetworkByDictionary, Net.cc:142+).

    ``dictionary``: word -> [(phone list, pronun log-prob or 0.0), ...].
    With keep_word_nodes the word node survives after its phone chain
    (word-link recording / output needs it); otherwise the last phone
    inherits the word identity.  Without multiple_pronun only the first
    variant is used.
    """
    nodes = list(net.nodes)
    back = _backlinks(nodes)
    out: List[NetNode] = []
    removed: List[NetNode] = []
    for n in nodes:
        if not (n.ntype & NT_WORD) or n.word is None:
            out.append(n)
            continue
        prons = dictionary.get(n.word)
        if prons is None:
            raise KeyError(f"word {n.word!r} not in dictionary")
        if not multiple_pronun:
            prons = prons[:1]
        preds = back[id(n)]
        # detach n from its predecessors; chains re-attach below
        for p, _ in preds:
            p.links = [(t, l) for t, l in p.links if t is not n]
        for var, (phones, pprob) in enumerate(prons, start=1):
            chain = [NetNode(ident=f"{n.ident}.v{var}.{k}", order=0,
                             ntype=NT_MODEL, model=ph)
                     for k, ph in enumerate(phones)]
            for a, b in zip(chain, chain[1:]):
                a.links.append((b, 0.0))
            out.extend(chain)
            if chain:
                for p, pl in preds:
                    p.links.append((chain[0], pl + pprob))
                tail = chain[-1]
                if keep_word_nodes:
                    tail.links.append((n, 0.0))
                else:
                    tail.word = n.word
                    tail.ntype |= NT_WORD | (n.ntype & NT_STICKY)
                    tail.pron_var = var
                    tail.links.extend(n.links)
            else:                       # empty pronunciation: bypass
                for p, pl in preds:
                    if keep_word_nodes:
                        p.links.append((n, pl + pprob))
                    else:
                        for t, tl in n.links:
                            p.links.append((t, pl + pprob + tl))
        if keep_word_nodes:
            # n survives IN PLACE as the pure word node after its chains
            # (object identity preserved, so later expansions that saw n
            # as a predecessor still hold valid references)
            out.append(n)
        else:
            removed.append(n)
    return _renumber(out)


def expand_to_triphones(net: StkNetwork,
                        ci_phones: Set[str] = frozenset({"sil", "sp"}),
                        ) -> StkNetwork:
    """Monophone model network -> triphone names L-m+R with node splitting
    per left context (ExpandMonophoneNetworkToTriphones semantics,
    Net.cc:774+): each model node is duplicated for every distinct
    left-context phone, and the right context is resolved per outgoing
    arc, so every compiled path sees the correct L-m+R chain.
    Context-independent phones (``ci_phones``, e.g. sil) take no context
    themselves but DO give context to neighbors — matching the STK naming
    walk (Net.cc:1080-1120, where only tee models are skipped when
    searching for context phones); word/null nodes are looked through."""
    nodes = list(net.nodes)
    # left contexts per node: phone of the nearest model predecessor
    back = _backlinks(nodes)

    def pred_phone(p: NetNode) -> Optional[str]:
        if p.is_model:
            return p.model
        return None                    # word/null nodes break context

    # build copies: (node, left) -> copy
    copies: Dict[Tuple[int, Optional[str]], NetNode] = {}
    new_nodes: List[NetNode] = []

    def get_copy(n: NetNode, left: Optional[str]) -> NetNode:
        if not n.is_model or n.model in ci_phones:
            left = None
        key = (id(n), left)
        if key in copies:
            return copies[key]
        c = NetNode(ident=n.ident if left is None else f"{n.ident}<{left}",
                    order=0, ntype=n.ntype, word=n.word, model=n.model,
                    pron_var=n.pron_var)
        copies[key] = c               # memoize BEFORE recursion (cycles)
        new_nodes.append(c)
        nxt_left = n.model if n.is_model else left
        for t, l in n.links:
            c.links.append((get_copy(t, nxt_left), l))
        return c

    root = get_copy(net.first, None)

    # second pass: assign triphone names; split nodes whose successors
    # imply different right contexts
    def succ_phone(t: NetNode, _seen: Optional[Set[int]] = None
                   ) -> Optional[str]:
        if t.is_model:
            return t.model          # CI phones give context too (STK walk)
        _seen = _seen or set()
        if id(t) in _seen:
            return None
        _seen.add(id(t))
        for t2, _ in t.links:       # look through word/null nodes
            return succ_phone(t2, _seen)
        return None

    final: List[NetNode] = []
    for c in new_nodes:
        if not c.is_model or c.model in ci_phones:
            final.append(c)
            continue
        rights = {}
        for t, l in c.links:
            rights.setdefault(succ_phone(t), []).append((t, l))
        left = c.ident.split("<")[1] if "<" in c.ident else None
        base = c.model
        items = sorted(rights.items(), key=lambda kv: str(kv[0]))
        first_name = True
        for r, arcs in items:
            name = base
            if left is not None:
                name = f"{left}-{name}"
            if r is not None:
                name = f"{name}+{r}"
            if first_name:
                c.model = name
                c.links = arcs
                final.append(c)
                first_name = False
            else:
                d = NetNode(ident=f"{c.ident}>{r}", order=0, ntype=c.ntype,
                            word=c.word, model=name, pron_var=c.pron_var)
                d.links = arcs
                final.append(d)
                # predecessors of c must also reach d
                for p in new_nodes:
                    for t, l in list(p.links):
                        if t is c:
                            p.links.append((d, l))
    # keep document order starting from the entry copy
    ordered = [root] + [n for n in final if n is not root]
    return _renumber(ordered)


def lattice_local_optimization(net: StkNetwork,
                               max_iters: int = 100) -> StkNetwork:
    """Iteratively merge equivalent nodes (LatticeLocalOptimization,
    Net.cc:633+): forward pass merges nodes with identical identity
    (word, model, type) and identical OUTGOING arcs; backward pass merges
    ones with identical INCOMING arcs.  Terminates at a fixed point."""
    nodes = list(net.nodes)

    def ident_key(n: NetNode):
        return (n.ntype, n.word, n.model, n.pron_var)

    def merge_once(direction: str) -> bool:
        nonlocal nodes
        back = _backlinks(nodes)
        sig: Dict[tuple, NetNode] = {}
        merged = False
        for n in list(nodes):
            if direction == "fwd":
                arcs = frozenset((id(t), round(l, 6)) for t, l in n.links)
            else:
                arcs = frozenset((id(p), round(l, 6))
                                 for p, l in back[id(n)])
            key = (ident_key(n), arcs)
            if key in sig:
                keep = sig[key]
                if keep is n:
                    continue
                # redirect n's other side onto keep
                if direction == "fwd":
                    for p, pl in back[id(n)]:
                        p.links = [(keep if t is n else t, l)
                                   for t, l in p.links]
                else:
                    for t, tl in n.links:
                        if (t, tl) not in keep.links:
                            keep.links.append((t, tl))
                nodes.remove(n)
                merged = True
            else:
                sig[key] = n
        # dedupe arcs after redirection
        for m in nodes:
            seen = {}
            uniq = []
            for t, l in m.links:
                if id(t) not in seen:
                    seen[id(t)] = True
                    uniq.append((t, l))
            m.links = uniq
        return merged

    for _ in range(max_iters):
        changed = merge_once("fwd")
        changed |= merge_once("bwd")
        if not changed:
            break
    return _renumber(nodes)
