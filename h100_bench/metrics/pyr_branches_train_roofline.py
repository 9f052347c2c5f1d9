"""Kernel ③'s forward share of its roofline in the train step."""

from h100_bench.layers_read import roofline_share


def read(r):
    return roofline_share(r, "pyr_branches") if r.train else None
