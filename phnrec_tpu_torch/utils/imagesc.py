"""ASCII heatmap dumper for debugging tensors.

Stand-in for STKLib's `imagesc` terminal visualizer (STKLib/imagesc.{C,h};
copy of phnrec_tpu/utils/imagesc.py): renders a 2-D array as a character/ANSI-color
heatmap scaled to the data range, with an optional transform (e.g. log).
Useful for eyeballing mel params, LCRC features, posteriors, or Viterbi
alpha lattices without leaving the terminal.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

# coarse-to-fine luminance ramp (gray colormap analogue, imagesc.C cm_gray)
GRAY_RAMP = " .:-=+*#%@"


def imagesc(data, title: str = "", transform: Optional[
        Callable[[np.ndarray], np.ndarray]] = None,
        max_cols: int = 120, max_rows: int = 40, color: bool = False) -> str:
    """Render ``data`` ([Y, X] array-like) as an ASCII heatmap string.

    Large arrays are mean-pooled down to at most max_rows x max_cols cells.
    ``color=True`` uses 256-color ANSI background blocks instead of the
    character ramp.
    """
    a = np.asarray(data, np.float32)
    if a.ndim == 1:
        a = a[None, :]
    if a.ndim != 2:
        raise ValueError("imagesc expects a 1-D or 2-D array")
    if transform is not None:
        a = np.asarray(transform(a), np.float32)

    ry = -(-a.shape[0] // max_rows)
    rx = -(-a.shape[1] // max_cols)
    if ry > 1 or rx > 1:
        py = (-a.shape[0]) % ry
        px = (-a.shape[1]) % rx
        a = np.pad(a, [(0, py), (0, px)], mode="edge")
        a = a.reshape(a.shape[0] // ry, ry, a.shape[1] // rx, rx).mean((1, 3))

    lo, hi = float(np.nanmin(a)), float(np.nanmax(a))
    span = (hi - lo) or 1.0
    norm = np.clip((a - lo) / span, 0.0, 1.0)

    lines = []
    if title:
        lines.append(f"-- {title}  [{a.shape[0]}x{a.shape[1]}]  "
                     f"min={lo:.4g} max={hi:.4g} --")
    if color:
        # 24-step grayscale band of the 256-color cube (232..255)
        idx = (232 + norm * 23).astype(int)
        for row in idx:
            lines.append("".join(f"\x1b[48;5;{v}m " for v in row)
                         + "\x1b[0m")
    else:
        idx = (norm * (len(GRAY_RAMP) - 1)).astype(int)
        for row in idx:
            lines.append("".join(GRAY_RAMP[v] for v in row))
    return "\n".join(lines)


def print_imagesc(data, **kw) -> None:
    print(imagesc(data, **kw))
