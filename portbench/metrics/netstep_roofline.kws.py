"""Kernel B's (ops/netstep.py) share of its roofline, %."""

from portbench.kws_work import netstep_roofline as read  # noqa: F401
