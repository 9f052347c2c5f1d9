"""Device-idle ms a batch inside the `mspl.generate.model:` spans: the card
waits while the host issues the sources' forwards."""

from h100_bench.program_spans import idle_us_in


def read(r):
    us = idle_us_in(r.view, ["mspl.generate.model:"])
    return None if us is None else r.per_unit_ms(us)
