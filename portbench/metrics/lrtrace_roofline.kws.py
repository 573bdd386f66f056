"""Kernel F's (ops/lrtrace.py) share of its roofline, %."""

from portbench.kws_work import lrtrace_roofline as read  # noqa: F401
