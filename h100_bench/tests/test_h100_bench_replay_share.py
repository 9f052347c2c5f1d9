"""The reader of `graph_replay_share.sweep` on hand-built profiler events:
replay spans over model spans in the window, and None without model
spans."""

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
    r = layers_read.Reading(view=view, units=1, cell=None, peak_bytes=0,
                            members=[], hw=(32, 48), batch=2, train=False)
    return layers_read._reader("graph_replay_share.sweep").read(r)


def test_two_model_spans_and_one_replay_read_50():
    assert _read(("mspl.generate.model:a", 10, 50),
                 ("mspl.generate.model:b", 60, 90),
                 ("mspl.generate.replay:b", 65, 85)) == 50.0


def test_spans_outside_the_window_are_not_counted():
    assert _read(("mspl.generate.model:a", 10, 50),
                 ("mspl.generate.replay:a", 20, 40),
                 ("mspl.generate.model:a", 1100, 1200)) == 100.0


def test_no_model_spans_read_none():
    assert _read(("mspl.generate.put", 10, 50)) is None
    assert _read() is None
