"""The share of the traced slice in which no operation ran on the device
(benchmark.shares.idle)."""

from benchmark.shares import idle

UNIT = "%"


def read(r):
    return idle(r)
