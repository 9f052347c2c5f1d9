"""Host ms a step in `mspl.train.upload`: the step's pageable copies of
image, label and valid rows to the card."""

from h100_bench.program_spans import host_us


def read(r):
    us = host_us(r.view, ["mspl.train.upload"])
    return None if us is None else r.per_unit_ms(us)
