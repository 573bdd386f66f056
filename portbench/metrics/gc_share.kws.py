"""The garbage collector's seconds over the window (spans ``gc`` and the
counter ``gc.g0_s`` of utils/profiling.py), %."""

from portbench.metrics._recorder import gc_share as read  # noqa: F401
