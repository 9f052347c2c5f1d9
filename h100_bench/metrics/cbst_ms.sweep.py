"""Host ms a batch in the `mspl.cbst.` spans: the sweep's CBST calls
(histograms, kc, re-threshold) with their host reads, which wait for the
sweep's last batch."""

from h100_bench.program_spans import host_us


def read(r):
    us = host_us(r.view, ["mspl.cbst."])
    return None if us is None else r.per_unit_ms(us)
