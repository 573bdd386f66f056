"""95th percentile of the window's rounds, from the call to the dispatch
to every stream's hits_so_far and the stream synchronised (a session's
last round includes finish()), in ms.  Read in the traced run, whose
profiler slows the host: a tail of a closed loop at capacity, beside its
throughput."""

import numpy as np


def read(t):
    if not t.item_s:
        return None
    return float(np.percentile(t.item_s, 95)) * 1e3
