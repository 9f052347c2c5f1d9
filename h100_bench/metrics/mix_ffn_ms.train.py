"""Device ms a step of the operations launched under the SegFormer's
Mix-FFN spans (`mspl.segformer.ffn:<stage>`) in the train forward: each
block's LayerNorm, fc1, depthwise convolution, GELU and fc2."""

MIX_FFN = "mspl.segformer.ffn:"


def read(r):
    us = r.view.device_us_under(lambda n: n.startswith(MIX_FFN))
    return r.per_unit_ms(us) if us else None
