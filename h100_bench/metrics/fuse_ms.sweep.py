"""Device ms a batch of kernels outside the model spans: normalization,
the input cast, the fused pass and the CBST histograms, kc and
re-threshold."""


def read(r):
    model = r.view.device_us_under(lambda n: n == "h100_bench.model")
    rest = r.view.kernels_us() - model
    return r.per_unit_ms(rest) if model and rest > 0 else None
