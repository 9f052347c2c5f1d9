"""Host ms a batch in `mspl.generate.put`: the program's pinning of each
batch and the issue of its upload (`PseudoLabelGenerator._put`)."""

from h100_bench.program_spans import host_us


def read(r):
    us = host_us(r.view, ["mspl.generate.put"])
    return None if us is None else r.per_unit_ms(us)
