"""Kernel ②, the whole eval tail of the classifier stage's pyramid pool
(`csrc/pyrpool.cu` down_prepass_kernel and pyr_tail_kernel): the branch
stack, BN+PReLU, the channel shuffle, the grouped 3x3 merge, BN+PReLU,
the 1x1 classifier and its affine.  Bytes: the P-channel input and the
O-channel output once each in the input's dtype, the f32 parameters."""

from h100_bench.roofline.pyr_branches import branch_ops
from h100_bench.roofline.shapes import SCALES, planes, proj_width

KERNELS = ("down_prepass_kernel", "pyr_tail_kernel")


def calls(models, hw, batch, train):
    """(b, p, o, h, w, itemsize) of the eval call at the 1/2 plane."""
    if train:
        return []
    h, w = planes(hw)[3]
    return [(batch, proj_width(m), m.classes, h, w, m.itemsize)
            for m in models if m.espnetv2]


def work(calls):
    s_n = len(SCALES)
    nbytes = ops = 0
    for b, p, o, h, w, size in calls:
        nbytes += b * h * w * (p + o) * size
        # dw_weights, aff1, merge weights, aff2, cls_w, cls_b, aff3
        nbytes += 4 * (9 * s_n * p + 3 * s_n * p + 9 * s_n * p + 3 * p
                       + p * o + o + 3 * o)
        ops += branch_ops(b, p, h, w) + b * h * w * (
            24 * s_n * p + 6 * p + 2 * p * o + 7 * o)
    return nbytes, ops, 0.0
