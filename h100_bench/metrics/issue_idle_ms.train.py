"""Device-idle ms a step inside the spans of the step's forward, loss,
backward and optimizer: the card waits while the host issues their
work."""

from h100_bench.program_spans import idle_us_in

SPANS = ["mspl.train.forward", "mspl.train.loss", "mspl.train.backward",
         "mspl.train.optimizer"]


def read(r):
    us = idle_us_in(r.view, SPANS)
    return None if us is None else r.per_unit_ms(us)
