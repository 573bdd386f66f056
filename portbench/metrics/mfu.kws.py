"""Model FLOPs of the window's valid frames at the float32 peak, %."""

from portbench.metrics._shared import mfu as read  # noqa: F401
