"""Device ms a step under `Optimizer.step#SGD.step`."""


def read(r):
    us = r.view.device_us_under(lambda n: n.startswith("Optimizer.step"))
    return r.per_unit_ms(us) if us else None
