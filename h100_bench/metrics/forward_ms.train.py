"""Device ms a step under the span on the model's train forward."""


def read(r):
    us = r.view.device_us_under(lambda n: n == "h100_bench.model")
    return r.per_unit_ms(us) if us else None
