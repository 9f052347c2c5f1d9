"""Device ms a step of the operations launched under the SegFormer's head
span (`mspl.segformer.head`) in the train forward: the stages' linear
layers, the upsampling, `linear_fuse`, `linear_pred` and the final
resize."""

HEAD = "mspl.segformer.head"


def read(r):
    us = r.view.device_us_under(lambda n: n == HEAD)
    return r.per_unit_ms(us) if us else None
