"""Median host time of a Server.tick that admitted nothing (one batched
decode step and host sampling), outside the traced slice."""

from benchmark.shares import tick_p50

UNIT = "ms"


def read(r):
    return tick_p50(r, "decode")
