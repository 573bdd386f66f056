"""Online-normalization parameter file I/O (reference: norm.cpp:309-462).

Copy of phnrec_tpu/io/normfile.py (host code without JAX, kept in step with it).

Dialect written by the reference's sxmlparser: a sequence of top-level
``<channel id="N">`` elements (no document root), each holding ``<mean>``,
``<variance>`` and optionally ``<gvariance>`` elements whose text is a
space-separated float vector ("%e" formatted).  Variances are stored as
variances; the runtime keeps inverse standard deviations.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np


def save_norm_file(path: str,
                   channels: Dict[int, Tuple[np.ndarray, np.ndarray]]) -> None:
    """channels: id -> (means, inv_stds); writes variances = 1/inv_std^2."""
    with open(path, "w") as f:
        for cid, (means, inv_stds) in sorted(channels.items()):
            f.write(f'<channel id="{cid}">\n')
            f.write("<mean>")
            f.write("".join(f" {v:e}" for v in means))
            f.write("</mean>\n<variance>")
            f.write("".join(f" {(1.0 / v) ** 2:e}" for v in inv_stds))
            f.write("</variance>\n</channel>\n")


_CHANNEL_RE = re.compile(r"<channel[^>]*\bid=\"(-?\d+)\"[^>]*>(.*?)</channel>",
                         re.S)
_ELEM_RE = re.compile(r"<(mean|variance|gvariance)>(.*?)</\1>", re.S)


def load_norm_file(path: str) -> Dict[int, Dict[str, np.ndarray]]:
    """-> {channel id: {"mean": ..., "inv_std": ..., "glob_std": ...?}}"""
    text = open(path).read()
    out: Dict[int, Dict[str, np.ndarray]] = {}
    for m in _CHANNEL_RE.finditer(text):
        cid = int(m.group(1))
        ch: Dict[str, np.ndarray] = {}
        for e in _ELEM_RE.finditer(m.group(2)):
            vec = np.array(e.group(2).split(), dtype=np.float32)
            if e.group(1) == "mean":
                ch["mean"] = vec
            elif e.group(1) == "variance":
                ch["inv_std"] = (1.0 / np.sqrt(vec)).astype(np.float32)
            else:
                ch["glob_std"] = np.sqrt(vec).astype(np.float32)
        out[cid] = ch
    return out
