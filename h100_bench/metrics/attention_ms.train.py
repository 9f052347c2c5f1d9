"""Device ms a step of the operations launched under the SegFormer's
attention spans (`mspl.segformer.attn:<stage>`) in the train forward: each
block's LayerNorm, spatial reduction, q, kv, the two products and proj."""

ATTENTION = "mspl.segformer.attn:"


def read(r):
    us = r.view.device_us_under(lambda n: n.startswith(ATTENTION))
    return r.per_unit_ms(us) if us else None
