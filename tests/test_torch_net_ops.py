"""The port's network surgery (net_ops.py on its io/stknet.py types)
against phnrec_tpu's: the seven networks of tests/test_net_ops.py and
seeded random word and phone networks give the same nodes (ident, type,
word, model, variant, order) and the same arcs (target index, like)."""

import numpy as np
import pytest

from phnrec_tpu import net_ops as J
from phnrec_tpu.io.stknet import parse_stk_network as jparse

from phnrec_tpu_torch import net_ops as P
from phnrec_tpu_torch.io.stknet import parse_stk_network as pparse

FIXED = {
    "null": """I=0 W=!NULL E=1
I=1 W=!NULL E=2 l=-1.5
I=2 W=hello E=3
I=3 W=!NULL
""",
    "self_link": """I=0 W=!NULL E=1
I=1 M=a E=1 E=2
I=2 W=!NULL
""",
    "cat": "I=0 W=!NULL E=1\nI=1 W=cat E=2\nI=2 W=!NULL\n",
    "go": "I=0 W=!NULL E=1\nI=1 W=go E=2\nI=2 W=!NULL\n",
    "linear": """I=0 W=!NULL E=1
I=1 M=sil E=2
I=2 M=a E=3
I=3 M=b E=4
I=4 M=c E=5
I=5 M=sil E=6
I=6 W=!NULL
""",
    "branching": """I=0 W=!NULL E=1
I=1 M=a E=2 E=3
I=2 M=b E=4
I=3 M=c E=4
I=4 W=!NULL
""",
    "diamond": """I=0 W=!NULL E=1 E=2
I=1 M=x E=3
I=2 M=x E=3
I=3 W=!NULL
""",
}
DICT = {"cat": [(["k", "ae", "t"], 0.0), (["k", "a", "t"], -0.7)],
        "go": [(["g", "ow"], 0.0)], "hello": [(["h", "l", "ow"], 0.0)],
        "w0": [(["a", "b"], 0.0), (["a"], -0.25)], "w1": [(["b", "c"], 0.0)],
        "w2": [(["sil"], 0.0)]}


def _dump(net):
    """Nodes and arcs; an arc into a node that left the list (a surgery
    can leave one, in both packages alike) names its target's ident."""
    index = {id(n): i for i, n in enumerate(net.nodes)}
    return [(n.ident, n.order, n.ntype, n.word, n.model, n.pron_var,
             [(index.get(id(t), t.ident), float(l)) for t, l in n.links])
            for n in net.nodes]


def _ops(text):
    """Every surgery on the network, each on a fresh parse: (name, fn of
    (module, net))."""
    ops = [("remove_null_nodes", lambda m, n: m.remove_null_nodes(n)),
           ("self_links_to_null_nodes",
            lambda m, n: m.self_links_to_null_nodes(n)),
           ("lattice_local_optimization",
            lambda m, n: m.lattice_local_optimization(n))]
    if "M=" in text:
        ops.append(("expand_to_triphones",
                    lambda m, n: m.expand_to_triphones(n)))
    else:
        for keep in (True, False):
            ops.append((f"expand_by_dictionary_{keep}",
                        lambda m, n, k=keep: m.expand_by_dictionary(
                            n, DICT, keep_word_nodes=k)))
    return ops


def _check(text):
    for name, fn in _ops(text):
        want = fn(J, jparse(text, is_text=True))
        got = fn(P, pparse(text, is_text=True))
        assert _dump(got) == _dump(want), name


@pytest.mark.parametrize("name", sorted(FIXED))
def test_fixed_networks_match_jax(name):
    _check(FIXED[name])


def _random_text(seed, models):
    """A random network: null first and last nodes, interior word (or
    model) and null nodes, forward arcs with likes in multiples of -1/4,
    some self-links and parallel twins (merge candidates)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3, 9))
    syms = ["a", "b", "c", "sil"] if models else ["w0", "w1", "w2"]
    labels = ["W=!NULL"]
    for _ in range(n):
        if rng.random() < 0.2:
            labels.append("W=!NULL")
        else:
            s = syms[int(rng.integers(0, len(syms)))]
            labels.append(f"M={s}" if models else f"W={s}")
    labels.append("W=!NULL")
    last = len(labels) - 1
    lines = []
    for i, lab in enumerate(labels):
        parts = [f"I={i}", lab]
        if i < last:
            succ = {i + 1} | {int(j) for j in rng.integers(
                i + 1, last + 1, int(rng.integers(0, 3)))}
            if 0 < i and rng.random() < 0.15 and lab != "W=!NULL":
                succ.add(i)
            for j in sorted(succ):
                parts.append(f"E={j}")
                if rng.random() < 0.5:
                    parts.append(f"l={-int(rng.integers(1, 8)) / 4}")
        lines.append(" ".join(parts))
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("seed", range(10))
def test_random_networks_match_jax(seed):
    _check(_random_text(seed, models=bool(seed % 2)))
