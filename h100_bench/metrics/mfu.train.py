"""The train step's share of the card's f32 peak (67 TFLOP/s, TF32 off):
forward and backward convolution FLOPs over the profiled window."""

from h100_bench.layers_read import mfu


def read(r):
    return mfu(r) if r.train else None
