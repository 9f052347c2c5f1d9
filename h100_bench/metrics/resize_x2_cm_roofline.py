"""Kernel ④'s share of its roofline over all its profiled calls."""

from h100_bench.layers_read import roofline_share


def read(r):
    return roofline_share(r, "resize_x2_cm")
