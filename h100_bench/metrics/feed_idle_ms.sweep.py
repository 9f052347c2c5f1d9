"""Device-idle ms a batch inside the host feed's spans, `mspl.loader.wait`
and `mspl.generate.put`: the idle time the feed holds the card back by."""

from h100_bench.program_spans import idle_us_in


def read(r):
    us = idle_us_in(r.view, ["mspl.loader.wait", "mspl.generate.put"])
    return None if us is None else r.per_unit_ms(us)
