"""Device ms a batch in the models but outside their encoders: the
decoders, DeepLab's ASPP, the final resizes."""


def read(r):
    model = r.view.device_us_under(lambda n: n == "h100_bench.model")
    enc = r.view.device_us_under(lambda n: n == "h100_bench.encoder")
    return r.per_unit_ms(model - enc) if model > enc else None
