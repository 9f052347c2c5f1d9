"""The sweep's share of the card's dense peak: each model's convolution
FLOPs at bf16 (989 TFLOP/s) or f32 (67 TFLOP/s, TF32 off) peak over the
profiled window."""

from h100_bench.layers_read import mfu


def read(r):
    return None if r.train else mfu(r)
