"""Median host time of a Server.tick that admitted a request (so ran its
prefill_slot), outside the traced slice."""

from benchmark.shares import tick_p50

UNIT = "ms"


def read(r):
    return tick_p50(r, "admit")
