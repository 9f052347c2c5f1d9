"""Kernel ③, the decoder's five-scale branch stack (`csrc/pyrpool.cu`
pyr_branches_kernel): per scale a resample, a depthwise 3x3 and a
resample back.  Bytes: the input read once, the S*P-channel output
written once in the input's dtype, the f32 weights.  Operations: the
resamples' and the taps' multiply-adds (a down scale's pool is one add a
source pixel, an up scale's interpolation 9 operations an output pixel)."""

from h100_bench.roofline.shapes import SCALES, branch_sizes, planes, proj_width

KERNELS = ("pyr_branches_kernel",)


def calls(models, hw, batch, train):
    """(b, p, h, w, itemsize) of each call in one batch or step: eval runs
    the stack in the three lower decoder blocks, train in all four."""
    out = []
    for m in models:
        if m.espnetv2:
            for h, w in planes(hw)[:4 if train else 3]:
                out.append((batch, proj_width(m), h, w, m.itemsize))
    return out


def branch_ops(b, p, h, w):
    ops = 0
    for (hs, ws), s in zip(branch_sizes(h, w, SCALES), SCALES):
        if s == 1.0:
            ops += 17 * h * w
            continue
        to = 9 * hs * ws if s > 1.0 else h * w + hs * ws
        ops += to + 17 * hs * ws + 9 * h * w
    return b * p * ops


def work(calls):
    nbytes = ops = 0
    for b, p, h, w, size in calls:
        nbytes += b * p * h * w * size * (1 + len(SCALES))
        nbytes += len(SCALES) * 9 * p * 4
        ops += branch_ops(b, p, h, w)
    return nbytes, ops, 0.0
