"""Mean host time of one fetch and decode of the KWS hits (spans
``kws.sync`` of multistream.py's MultiStreamKWS, counter
``kws.syncs``), ms."""

from portbench.metrics._recorder import snapshot, span_s


def read(t):
    snap = snapshot()
    if snap is None or not snap.counters.get("kws.syncs"):
        return None
    return 1e3 * span_s(snap, "kws.sync") / snap.counters["kws.syncs"]
