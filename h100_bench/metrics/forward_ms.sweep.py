"""Device ms a batch of the kernels launched under the program's
`mspl.generate.model:` spans, eager or replayed from a CUDA graph (each
replayed kernel shares its `cudaGraphLaunch`'s correlation id), summed
over the ensemble.  None without model spans (a program before them)."""

from h100_bench.program_spans import host_us

MODEL = "mspl.generate.model:"


def read(r):
    if host_us(r.view, [MODEL]) is None:
        return None
    us = r.view.device_us_under(lambda n: n.startswith(MODEL),
                                kernels_only=True)
    return r.per_unit_ms(us) if us else None
