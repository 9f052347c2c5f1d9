"""Host ms a step in `mspl.loader.wait`: the train loop's wait for the
port's loader to hand over a batch."""

from h100_bench.program_spans import host_us


def read(r):
    us = host_us(r.view, ["mspl.loader.wait"])
    return None if us is None else r.per_unit_ms(us)
