"""STK network file parser — the dialect ReadSTKNetwork accepts
(STKLib/Net_IO.cc:687-1010), scoped to what phnrec produces/consumes:
netgen phoneme loops, kwsnetg KWS networks, and hand-written HTK-SLF-ish
lattices with I=/W=/M=/f= fields and E= arcs with l= LM scores.

Copy of phnrec_tpu/io/stknet.py (host code without JAX, kept in step with it).

Line grammar (whitespace-separated fields):
  header lines:  N=<nnodes> [L=<nlinks>] (and any skipped keyword)
  node lines:    <id> | I=<id>, then W=<word>|!NULL, M=<model>, v=<var>,
                 f=<flags K/F/T>, then E=<target> [l=<like>] arc pairs or
                 bare target ids.
A bare first field is the node id; bare fields after the node definition
are arc targets (the netgen output form, netgen.cpp:120-160).
Nodes are created on first reference; '.' ends the network in an MLF-like
stream.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

NT_WORD, NT_MODEL, NT_STICKY, NT_TRUE = 1, 2, 4, 8


@dataclass
class NetNode:
    ident: str
    order: int                      # document order (STK processing order)
    ntype: int = 0                  # bit mask of NT_*
    word: Optional[str] = None      # W= (None for !NULL / non-word nodes)
    model: Optional[str] = None     # M=
    pron_var: int = 1
    links: List[Tuple["NetNode", float]] = field(default_factory=list)

    @property
    def is_model(self) -> bool:
        return bool(self.ntype & NT_MODEL)

    @property
    def is_null(self) -> bool:
        """A word node with no pronunciation (W=!NULL or bare id)."""
        return not self.is_model and self.word is None

    @property
    def is_sticky(self) -> bool:
        return bool(self.ntype & NT_STICKY)


@dataclass
class StkNetwork:
    nodes: List[NetNode]            # in document order

    @property
    def first(self) -> NetNode:
        return self.nodes[0]

    @property
    def last(self) -> NetNode:
        # STK's mpLast: the network end = the node with no outgoing links
        for n in self.nodes:
            if not n.links:
                return n
        return self.nodes[-1]


def parse_stk_network(path_or_text: str, is_text: bool = False) -> StkNetwork:
    text = path_or_text if is_text else open(path_or_text,
                                             encoding="latin-1").read()
    nodes: Dict[str, NetNode] = {}
    order: List[NetNode] = []

    def get_node(ident: str) -> NetNode:
        if ident not in nodes:
            nodes[ident] = NetNode(ident=ident, order=len(order))
            order.append(nodes[ident])
        return nodes[ident]

    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line == ".":
            break
        fields = line.split()
        node: Optional[NetNode] = None
        target: Optional[NetNode] = None
        i = 0
        while i < len(fields):
            f = fields[i]
            key, eq, val = f.partition("=")
            if node is None:
                # first field: I=<id> or bare <id>, J=<n> opens an
                # HTK-SLF arc-definition line, else a header line
                if not eq:
                    if key in ("N", "NODES", "L", "LINKS", "J", "S",
                               "VERSION"):
                        break
                    node = get_node(key)
                elif key == "I":
                    node = get_node(val)
                elif key == "J":
                    # HTK-SLF / old-format arc line (Net_IO.cc:741-751,
                    # 1223-1234): J=<n> S=<src> E=<dst> [a=..] [l=<like>]
                    src = dst = None
                    like = 0.0
                    for f2 in fields[1:]:
                        k2, _, v2 = f2.partition("=")
                        if k2 in ("S", "START"):
                            src = get_node(v2)
                        elif k2 in ("E", "END"):
                            dst = get_node(v2)
                        elif k2 in ("l", "language"):
                            like = float(v2)
                        # a= (acoustic like), d= (div): accepted, unused
                    if src is None or dst is None:
                        raise ValueError(
                            f"J= arc line needs S= and E=: {raw!r}")
                    src.links.append((dst, like))
                    break
                else:
                    break  # header line (N=..., VERSION=..., etc.)
                i += 1
                continue
            if not eq:
                # bare arc target (netgen form)
                target = get_node(key)
                node.links.append((target, 0.0))
            elif key in ("E", "END"):
                target = get_node(val)
                node.links.append((target, 0.0))
            elif key in ("l", "language"):
                if target is None:
                    raise ValueError(f"l= before arc in line: {raw!r}")
                node.links[-1] = (node.links[-1][0], float(val))
            elif key in ("W", "WORD"):
                node.word = None if val == "!NULL" else val
                node.ntype = (node.ntype & ~NT_MODEL) | NT_WORD
            elif key in ("M", "MODEL"):
                node.model = val
                node.ntype = (node.ntype & ~NT_WORD) | NT_MODEL
            elif key in ("f", "flag"):
                for c in val.upper():
                    if c in ("K", "F"):
                        node.ntype |= NT_STICKY
                    elif c == "T":
                        node.ntype |= NT_TRUE
                    else:
                        raise ValueError(f"Invalid flag {c!r}")
            elif key in ("v", "var"):
                node.pron_var = int(val)
            elif key in ("t", "time", "p", "d", "div"):
                pass  # times/accuracies/phone marks: accepted, unused
            i += 1

    if not order:
        raise ValueError("empty network")
    return StkNetwork(nodes=order)


def write_stk_network(net: StkNetwork, path_or_file) -> None:
    """Write a network in the STK dialect (WriteSTKNetwork,
    Net_IO.cc:144-230 with default format flags): `N=` header, one
    `I=<idx>` line per node in document order with `W=`/`M=`, `v=`
    pronunciation variant, `f=` T/K flags, and `E=<idx> [l=<like>]`
    arcs.  Round-trips through parse_stk_network; used to persist
    net_ops-transformed networks (dictionary/triphone expansion,
    lattice optimization)."""
    own = isinstance(path_or_file, str)
    f = open(path_or_file, "w") if own else path_or_file

    def checked(name: str) -> str:
        # the whitespace-tokenizing dialect cannot represent these; emit
        # a loud error rather than a file parse_stk_network mis-reads
        if any(c.isspace() for c in name) or "=" in name:
            raise ValueError(
                f"node name {name!r} contains whitespace or '=' and "
                "cannot be written in the STK network dialect")
        return name

    try:
        index = {id(n): i for i, n in enumerate(net.nodes)}
        n_links = sum(len(n.links) for n in net.nodes)
        f.write(f"N={len(net.nodes)} L={n_links}\n")
        for i, n in enumerate(net.nodes):
            parts = [f"I={i}"]
            if n.is_model:
                parts.append(f"M={checked(n.model)}")
            else:
                parts.append("W=" + (checked(n.word) if n.word is not None
                                     else "!NULL"))
                if n.word is not None and n.pron_var != 1:
                    parts.append(f"v={n.pron_var}")
            if n.ntype & (NT_TRUE | NT_STICKY):
                flags = ("T" if n.ntype & NT_TRUE else "") + \
                        ("K" if n.ntype & NT_STICKY else "")
                parts.append(f"f={flags}")
            for tgt, like in n.links:
                parts.append(f"E={index[id(tgt)]}")
                if like != 0.0:
                    parts.append(f"l={like:g}")
            f.write(" ".join(parts) + "\n")
    finally:
        if own:
            f.close()
