"""The list path's consumer blocked on the loader (span
``list.loader_wait``, parallel/loader.py) over the window, %."""

from portbench.metrics._recorder import share, snapshot, span_s


def read(t):
    snap = snapshot()
    if snap is None or "list.loader_wait" not in snap.spans:
        return None
    return share(t, span_s(snap, "list.loader_wait"))
