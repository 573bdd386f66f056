"""Mean wait of one serving commit on the card (spans ``fetch.wait``
inside ``serve.commit``: the rounds still queued at its start, then the
segments' event and any refetch; counter ``serve.commits``), ms."""

from portbench.metrics._recorder import snapshot


def read(t):
    snap = snapshot()
    if snap is None or not snap.counters.get("serve.commits"):
        return None
    wait = snap.within.get(("serve.commit", "fetch.wait"))
    return 1e3 * (wait.total_s if wait else 0.0) \
        / snap.counters["serve.commits"]
