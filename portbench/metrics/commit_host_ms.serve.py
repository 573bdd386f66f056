"""Mean host time of one serving commit (spans ``serve.commit`` of
multistream.py, counter ``serve.commits``) less its wait on the card (its
``fetch.wait``), ms."""

from portbench.metrics._recorder import snapshot


def read(t):
    snap = snapshot()
    commit = snap and snap.spans.get("serve.commit")
    if not commit or not snap.counters.get("serve.commits"):
        return None
    wait = snap.within.get(("serve.commit", "fetch.wait"))
    return 1e3 * (commit.total_s - (wait.total_s if wait else 0.0)) \
        / snap.counters["serve.commits"]
