"""The reader of `graph_replay_share.train` on hand-built profiler events:
replay spans over the train step's forward spans in the window, and None
without forward spans."""

from types import SimpleNamespace

from torch.autograd import DeviceType

from h100_bench import layers_read
from h100_bench.trace import WINDOW, TraceView


def _event(name, a, b):
    return SimpleNamespace(
        name=name, device_type=DeviceType.CPU,
        time_range=SimpleNamespace(start=a, end=b), thread=1, id=0,
        is_user_annotation=False)


def _read(*spans):
    view = TraceView([_event(WINDOW, 0, 1000)]
                     + [_event(*s) for s in spans])
    r = layers_read.Reading(view=view, units=2, cell=None, peak_bytes=0,
                            members=[], hw=(32, 48), batch=2, train=True)
    return layers_read._reader("graph_replay_share.train").read(r)


def test_two_forwards_and_one_replay_read_50():
    assert _read(("mspl.train.forward", 10, 50),
                 ("mspl.train.replay", 20, 40),
                 ("mspl.train.forward", 60, 90)) == 50.0


def test_every_forward_replayed_reads_100():
    assert _read(("mspl.train.forward", 10, 50),
                 ("mspl.train.replay", 20, 40),
                 ("mspl.train.forward", 60, 90),
                 ("mspl.train.replay", 70, 80)) == 100.0


def test_spans_outside_the_window_are_not_counted():
    assert _read(("mspl.train.forward", 10, 50),
                 ("mspl.train.replay", 20, 40),
                 ("mspl.train.forward", 1100, 1200)) == 100.0


def test_an_eager_program_reads_0_and_no_forward_reads_none():
    assert _read(("mspl.train.forward", 10, 50),
                 ("mspl.train.loss", 50, 60)) == 0.0
    assert _read(("mspl.train.upload", 10, 50)) is None
    assert _read() is None
