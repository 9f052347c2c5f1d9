"""100 x (1 - the union of kernel, copy and set intervals over the
profiled window)."""


def read(r):
    if r.view.window_us <= 0 or not r.view.dev:
        return None
    return 100.0 * (1.0 - r.view.busy_us() / r.view.window_us)
