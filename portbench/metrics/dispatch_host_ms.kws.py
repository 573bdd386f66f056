"""Mean host wall of one window round's dispatch_from_device_buffer call
of MultiStreamKWS (the hits are fetched and decoded later, in
hits_so_far), ms: the last of the spans ``dispatch``, one a round, as the
warm-up's come first."""


def read(t):
    spans = t.spans.get("dispatch")
    n = len(t.item_s)
    if not spans or not n:
        return None
    return 1e3 * sum(spans[-n:]) / len(spans[-n:])
