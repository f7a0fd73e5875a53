"""The traced slice's work, as the roofline bounds it, over its wall time:
the whole step's share of the H100's peak (benchmark.shares.mfu)."""

from benchmark.shares import mfu

UNIT = "%"


def read(r):
    return mfu(r)
