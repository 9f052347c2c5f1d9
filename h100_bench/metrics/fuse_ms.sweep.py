"""Device ms a batch of the kernels launched outside the program's
`mspl.generate.model:` spans: normalization, the input cast, the fused
pass ① and the CBST histograms, kc and re-threshold.  With
`forward_ms.sweep` it splits the batch's kernel time.  None without model
spans (a program before them)."""

from h100_bench.program_spans import host_us

MODEL = "mspl.generate.model:"


def read(r):
    if host_us(r.view, [MODEL]) is None:
        return None
    model = r.view.device_us_under(lambda n: n.startswith(MODEL),
                                   kernels_only=True)
    rest = r.view.kernels_us() - model
    return r.per_unit_ms(rest) if rest > 0 else None
