"""A scoped pause of CPython's cyclic garbage collector."""

from __future__ import annotations

import contextlib
import gc
from typing import Iterator


@contextlib.contextmanager
def paused() -> Iterator[None]:
    """Disable the collector inside the block and restore its previous
    state after it, also when the block raises (a caller that had it
    disabled keeps it disabled).  For a pass that makes many objects that
    can form no cycle: a collection inside it would free nothing and
    only walk every object that survives again."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()
