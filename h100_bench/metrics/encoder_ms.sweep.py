"""Device ms a batch under the encoder spans (ESPNetv2 `base_net`,
DeepLab `encoder`), summed over the ensemble."""


def read(r):
    us = r.view.device_us_under(lambda n: n == "h100_bench.encoder")
    return r.per_unit_ms(us) if us else None
