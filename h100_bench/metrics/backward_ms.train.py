"""Device ms a step under autograd's evaluate_function ranges: the
loss's backward, the model's, kernel ③'s plain backward."""


def read(r):
    us = r.view.device_us_under(
        lambda n: n.startswith("autograd::engine::evaluate_function"))
    return r.per_unit_ms(us) if us else None
