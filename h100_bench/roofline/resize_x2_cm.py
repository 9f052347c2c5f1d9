"""Kernel ④, the x2 bilinear resize of the logits (`csrc/resize_x2.cu`
resize_rows_kernel).  Bytes: the input and the output once each, each at
its own element size.  Operations: 9 an output pixel (two taps an axis)."""

from h100_bench.roofline.shapes import planes

KERNELS = ("resize_rows_kernel",)


def calls(models, hw, batch, train):
    """(b, c, hi, wi, ho, wo, in itemsize, out itemsize) in eval."""
    if train:
        return []
    hi, wi = planes(hw)[3]
    return [(batch, m.classes, hi, wi, hw[0], hw[1], m.itemsize, m.itemsize)
            for m in models if m.espnetv2]


def work(calls):
    nbytes = ops = 0
    for b, c, hi, wi, ho, wo, s_in, s_out in calls:
        nbytes += b * c * (hi * wi * s_in + ho * wo * s_out)
        ops += 9 * b * c * ho * wo
    return nbytes, ops, 0.0
