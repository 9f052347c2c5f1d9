"""Device ms a step of the operations launched under `mspl.train.augment`:
normalization, scale, crop and flip."""

from h100_bench.program_spans import host_us

AUGMENT = "mspl.train.augment"


def read(r):
    if not r.view.dev or host_us(r.view, [AUGMENT]) is None:
        return None
    return r.per_unit_ms(r.view.device_us_under(lambda n: n == AUGMENT))
