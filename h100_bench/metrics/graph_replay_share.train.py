"""The share of the train steps' model forwards that replay a CUDA graph:
100 x the `mspl.train.replay` spans over the `mspl.train.forward` spans
that start in the profiled window.  None without forward spans (a program
before them); a program that replays nothing reads 0."""


def read(r):
    lo, hi = r.view.window

    def count(name):
        return sum(1 for n, a, _, _ in r.view.cpu
                   if n == name and lo <= a <= hi)

    forwards = count("mspl.train.forward")
    return (100.0 * count("mspl.train.replay") / forwards if forwards
            else None)
