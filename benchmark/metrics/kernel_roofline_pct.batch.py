"""The traced slice's work, as the roofline bounds it, over the time some
operation ran on the device: the kernels' share of their roofline, the
same whatever kernels do the work (benchmark.shares.kernel_roofline)."""

from benchmark.shares import kernel_roofline

UNIT = "%"


def read(r):
    return kernel_roofline(r)
