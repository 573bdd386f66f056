"""Arithmetic that several per-layer readers share."""

from portbench.work import bound_s, mlp_work


def mlp_roofline(t):
    """Kernel A's share of its roofline over the window, in %: the sum of
    each launch's bound (its rows, padding included, at its net's widths)
    over A's device time from the profiler.  None without launches or
    without device time."""
    rows = t.launches.get("A", [])
    dev_s = t.kernel_s.get("A", 0.0)
    if not rows or dev_s <= 0.0:
        return None
    return 100.0 * sum(bound_s(*mlp_work(*r)) for r in rows) / dev_s


def idle_share(t):
    """The share of the window in which no kernel or copy ran, in %."""
    if not t.on_device or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu(t):
    """Model FLOPs on valid frames over the window at the float32 peak,
    in %: the configuration runs at precision `highest`."""
    if not t.on_device or t.window_s <= 0:
        return None
    return 100.0 * t.model_flops / (t.window_s * t.peak_fp32)
