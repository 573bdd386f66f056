"""Share of the window with no kernel or copy on the card, %."""

from portbench.metrics._shared import idle_share as read  # noqa: F401
