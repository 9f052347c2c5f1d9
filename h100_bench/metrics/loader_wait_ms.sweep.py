"""Host ms a batch in `mspl.loader.wait`: the generator's wait for the
port's loader to hand over a batch (the producer thread's gather, seen from
the consuming thread)."""

from h100_bench.program_spans import host_us


def read(r):
    us = host_us(r.view, ["mspl.loader.wait"])
    return None if us is None else r.per_unit_ms(us)
