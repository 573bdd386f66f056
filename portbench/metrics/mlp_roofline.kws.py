"""Kernel A's (ops/mlp_fused.py) share of its float32 roofline, %."""

from portbench.metrics._shared import mlp_roofline as read  # noqa: F401
