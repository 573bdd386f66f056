"""Traffic drivers of kinds that portbench.traffic.DRIVERS does not hold,
one module a kind: ``portbench/drivers/<kind>.py`` defines ``Driver``."""
