"""The readers of the program's spans (`program_spans.py` and the metrics
that use it) on hand-built profiler events: host time in a union of spans,
and device-idle time inside them where gaps lie partly inside a span, run
across two spans, or lie outside every span; each reader gives None on a
view without `mspl.` events (a program before the spans)."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from h100_bench import layers_read, program_spans
from h100_bench.trace import WINDOW, TraceView

NEW = ["loader_wait_ms.sweep", "put_ms.sweep", "feed_idle_ms.sweep",
       "issue_idle_ms.sweep", "cbst_ms.sweep", "loader_wait_ms.train",
       "upload_ms.train", "feed_idle_ms.train", "issue_idle_ms.train",
       "augment_ms.train"]


def _event(name, a, b, thread=1, dev=False, cid=0):
    return SimpleNamespace(
        name=name, device_type=DeviceType.CUDA if dev else DeviceType.CPU,
        time_range=SimpleNamespace(start=a, end=b), thread=thread, id=cid,
        is_user_annotation=False)


def _kernel(a, b, cid, launch_at, thread=1):
    """A kernel on the device and its launch on the host."""
    return [_event(f"kernel_{cid}", a, b, dev=True, cid=cid),
            _event("cudaLaunchKernel", launch_at, launch_at + 1, thread,
                   cid=cid)]


# the device is busy on [100, 200], [400, 600] and [800, 900] of the
# window [0, 1000], and a kernel that runs past the window's end is
# clipped; idle: [0, 100], [200, 400], [600, 800], [900, 990]
DEVICE = (_kernel(100, 200, 1, 60) + _kernel(400, 600, 2, 320)
          + _kernel(800, 900, 3, 700) + _kernel(990, 1200, 4, 720))
BASE = [_event(WINDOW, 0, 1000)] + DEVICE


def _view(*spans):
    return TraceView(BASE + [_event(*s) for s in spans])


def test_host_us_is_the_union_over_prefixes_and_threads():
    view = _view(("mspl.loader.wait", 10, 50),
                 ("mspl.loader.wait", 40, 80, 2),  # overlaps, other thread
                 ("mspl.generate.put", 70, 100),
                 ("mspl.cbst.kc", 500, 520),
                 ("mspl.cbst.sweep_kc", 490, 530),  # encloses kc
                 ("aten::copy_", 0, 1000))
    assert program_spans.host_us(view, ["mspl.loader.wait"]) == 70
    assert program_spans.host_us(
        view, ["mspl.loader.wait", "mspl.generate.put"]) == 90
    assert program_spans.host_us(view, ["mspl.cbst."]) == 40
    assert program_spans.host_us(view, ["mspl.train."]) is None


def test_idle_partly_inside_a_span():
    # [50, 150] holds the last 50 of the gap [0, 100]
    view = _view(("mspl.loader.wait", 50, 150))
    assert program_spans.idle_us_in(view, ["mspl.loader.wait"]) == 50


def test_a_span_over_two_gaps_and_a_gap_over_two_spans():
    # [300, 700] takes 100 of the gap [200, 400] and 100 of [600, 800];
    # the gap [200, 400] also runs across two spans of another prefix
    view = _view(("mspl.generate.put", 300, 700),
                 ("mspl.generate.model:a", 210, 250),
                 ("mspl.generate.model:b", 260, 330, 2))
    assert program_spans.idle_us_in(view, ["mspl.generate.put"]) == 200
    assert program_spans.idle_us_in(view, ["mspl.generate.model:"]) == 110
    # the union: [210, 250] + [260, 400] of the gap, then [600, 700]
    assert program_spans.idle_us_in(
        view, ["mspl.generate.put", "mspl.generate.model:"]) == 280


def test_gaps_outside_every_span_count_nothing():
    view = _view(("mspl.train.forward", 420, 580),  # all busy
                 ("mspl.train.loss", 960, 1100))    # past the window
    assert program_spans.idle_us_in(view, ["mspl.train.forward"]) == 0
    # the kernel clipped at 1000 keeps [990, 1000] busy
    assert program_spans.idle_us_in(view, ["mspl.train.loss"]) == 30
    assert program_spans.host_us(view, ["mspl.train.loss"]) == 40


def _reading(view, units=2):
    return layers_read.Reading(view=view, units=units, cell=None,
                               peak_bytes=0, members=[], hw=(32, 48),
                               batch=2, train=False)


def test_readers_per_unit():
    view = _view(("mspl.loader.wait", 50, 150),
                 ("mspl.generate.put", 300, 700),
                 ("mspl.generate.model:a", 210, 250),
                 ("mspl.cbst.sweep_kc", 900, 950),
                 ("mspl.train.upload", 610, 630),
                 ("mspl.train.augment", 300, 420),  # launches kernel 2
                 ("mspl.train.backward", 880, 1000))
    r = _reading(view)
    got = {n: layers_read._reader(n).read(r) for n in NEW}
    assert got == pytest.approx({
        "loader_wait_ms.sweep": 0.05, "put_ms.sweep": 0.2,
        "feed_idle_ms.sweep": 0.125, "issue_idle_ms.sweep": 0.02,
        "cbst_ms.sweep": 0.025, "loader_wait_ms.train": 0.05,
        "upload_ms.train": 0.01, "feed_idle_ms.train": 0.035,
        "issue_idle_ms.train": 0.045, "augment_ms.train": 0.1})


@pytest.mark.parametrize("name", NEW)
def test_readers_give_none_without_program_spans(name):
    view = _view(("aten::pin_memory", 0, 100), ("h100_bench.model", 0, 900))
    assert layers_read._reader(name).read(_reading(view)) is None


@pytest.mark.parametrize("name", NEW)
def test_readers_give_none_without_a_window(name):
    assert layers_read._reader(name).read(_reading(TraceView([]))) is None
