"""The share of the sources' forwards that replay a CUDA graph: 100 x the
`mspl.generate.replay:` spans over the `mspl.generate.model:` spans that
start in the profiled window.  None without model spans (a program before
them); a program that replays nothing reads 0."""


def read(r):
    lo, hi = r.view.window

    def count(prefix):
        return sum(1 for n, a, _, _ in r.view.cpu
                   if n.startswith(prefix) and lo <= a <= hi)

    models = count("mspl.generate.model:")
    return 100.0 * count("mspl.generate.replay:") / models if models else None
