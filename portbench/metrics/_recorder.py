"""The program's own spans and counters over the traced window: the
snapshot of ``phnrec_tpu_torch.utils.profiling.RECORDER``, whose capture
follows the window's torch.profiler run.  None where the program has no
recorder, so that its metrics are left out."""


def snapshot():
    from phnrec_tpu_torch.utils import profiling
    recorder = getattr(profiling, "RECORDER", None)
    return recorder.snapshot() if recorder is not None else None


def span_s(snap, name: str, kind: str = "total_s") -> float:
    """The seconds of the spans ``name`` (``total_s`` or ``self_s``), 0
    without one."""
    st = snap.spans.get(name)
    return getattr(st, kind) if st is not None else 0.0


def share(t, seconds: float):
    """``seconds`` over the window, %."""
    if t.window_s <= 0:
        return None
    return 100.0 * seconds / t.window_s


def gc_share(t):
    """The collector's seconds over the window, %: the spans ``gc``
    (generations 1 and 2) and the generation 0 collections' summed
    seconds."""
    snap = snapshot()
    if snap is None:
        return None
    return share(t, span_s(snap, "gc") + snap.counters.get("gc.g0_s", 0.0))


def label_build_us(t):
    """Self time of ``labels.build`` (the collector's spans inside it are
    gc_share's) over ``labels.built``, µs a label."""
    snap = snapshot()
    if snap is None or not snap.counters.get("labels.built"):
        return None
    return 1e6 * span_s(snap, "labels.build", "self_s") \
        / snap.counters["labels.built"]
