"""Kernel ①, the fused pseudo-label pass over channel-major logits
(`csrc/pseudo_cm.cuh` pseudo_cm_kernel): each model's softmax, its
conversion into the T target classes, the mean, the label, its
confidence and the threshold.  Bytes: every model's logits once, an
int32 label and an f32 confidence a pixel."""

KERNELS = ("pseudo_cm_kernel",)
NUM_TARGET = 3


def calls(models, hw, batch, train):
    """One call a batch: ([(classes, itemsize) a model], pixels)."""
    if train:
        return []
    return [([(m.classes, m.itemsize) for m in models],
             batch * hw[0] * hw[1])]


def work(calls):
    nbytes = ops = 0
    t = NUM_TARGET
    for models, px in calls:
        c_sum = sum(c for c, _ in models)
        nbytes += sum(c * size for c, size in models) * px + px * 8
        ops += px * (6 * c_sum + len(models) * (t + 2) + 3 * t + 10)
    return nbytes, ops, 0.0
