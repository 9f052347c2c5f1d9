"""Device-idle ms a step inside the host feed's spans, `mspl.loader.wait`
and `mspl.train.upload`."""

from h100_bench.program_spans import idle_us_in


def read(r):
    us = idle_us_in(r.view, ["mspl.loader.wait", "mspl.train.upload"])
    return None if us is None else r.per_unit_ms(us)
