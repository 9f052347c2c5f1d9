"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit)."""

MEM_BPS = 3.35e12   # HBM3 bytes a second
F32_OPS = 67e12     # f32 arithmetic outside the tensor cores
TF32_TC = 495e12    # TF32 tensor-core products
BF16_TC = 989e12    # bf16 tensor-core products
FP8_TC = 1979e12    # fp8 tensor-core products

# the dense matrix-product peak a model computes at, by its dtype (f32
# runs with TF32 off, so outside the tensor cores)
DENSE_PEAK = {"float32": F32_OPS, "bfloat16": BF16_TC}


def bound_ms(nbytes: float, ops: float, tc_ops: float = 0.0):
    """(ms, the limiting term): the largest of the bytes at the memory
    rate, f32 work at the f32 rate and matrix-product work at the bf16
    tensor-core rate."""
    terms = [(nbytes / MEM_BPS * 1e3, "bytes"),
             (ops / F32_OPS * 1e3, "f32 operations"),
             (tc_ops / BF16_TC * 1e3, "bf16 products")]
    return max(terms)
