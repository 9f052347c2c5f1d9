"""Host ms a batch in `aten::pin_memory`: the generator pins each batch
anew before its upload (`pseudo/generate.py` `_put`)."""


def read(r):
    us = r.view.host_us("aten::pin_memory") or r.view.host_us(
        "aten::_pin_memory")
    return r.per_unit_ms(us) if us else None
