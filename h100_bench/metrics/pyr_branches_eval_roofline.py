"""Kernel ③'s share of its roofline in the sweep (eval)."""

from h100_bench.layers_read import roofline_share


def read(r):
    return None if r.train else roofline_share(r, "pyr_branches")
