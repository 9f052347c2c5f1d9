"""The readers of `forward_ms.sweep` and `fuse_ms.sweep` on hand-built
profiler events: kernels launched under the program's
`mspl.generate.model:` spans, eagerly or by one replayed CUDA graph whose
kernels share their `cudaGraphLaunch`'s correlation id, against those
launched outside them; the two split the batch's kernel time, copies
left out."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from h100_bench import layers_read
from h100_bench.trace import WINDOW, TraceView


def _event(name, a, b, thread=1, dev=False, cid=0):
    return SimpleNamespace(
        name=name, device_type=DeviceType.CUDA if dev else DeviceType.CPU,
        time_range=SimpleNamespace(start=a, end=b), thread=thread, id=cid,
        is_user_annotation=False)


def _events():
    """Window [0, 1000]: normalize launched outside every span (kernel
    [50, 70]); source a's eager forward (two kernels, 100 us); source b's
    replay, one `cudaGraphLaunch` (cid 9) whose three kernels take 300 us;
    the fused pass ① after the spans (kernel [800, 840]); the upload's
    copy (not a kernel) inside a's span."""
    return [
        _event(WINDOW, 0, 1000),
        _event("mspl.generate.model:a", 100, 200),
        _event("mspl.generate.model:b", 210, 260),
        _event("mspl.generate.replay:b", 215, 255),
        _event("cudaLaunchKernel", 40, 41, cid=1),
        _event("normalize_kernel", 50, 70, dev=True, cid=1),
        _event("cudaLaunchKernel", 110, 111, cid=2),
        _event("conv_kernel", 120, 180, dev=True, cid=2),
        _event("cudaLaunchKernel", 150, 151, cid=3),
        _event("bn_kernel", 180, 220, dev=True, cid=3),
        _event("cudaMemcpyAsync", 160, 161, cid=4),
        _event("Memcpy HtoD (Pinned -> Device)", 190, 230, dev=True, cid=4),
        _event("cudaGraphLaunch", 220, 230, cid=9),
        _event("conv_kernel", 230, 400, dev=True, cid=9),
        _event("pyr_tail_kernel", 400, 480, dev=True, cid=9),
        _event("resize_rows_kernel", 480, 530, dev=True, cid=9),
        _event("cudaLaunchKernel", 700, 701, cid=5),
        _event("pseudo_cm_kernel", 800, 840, dev=True, cid=5),
    ]


def _read(name, events, units=2):
    r = layers_read.Reading(view=TraceView(events), units=units, cell=None,
                            peak_bytes=0, members=[], hw=(32, 48), batch=2,
                            train=False)
    return layers_read._reader(name).read(r)


def test_forward_and_fuse_split_the_kernel_time():
    ev = _events()
    forward = _read("forward_ms.sweep", ev)
    fuse = _read("fuse_ms.sweep", ev)
    # a's two kernels (60 + 40) and b's replayed three (300), per batch
    assert forward == pytest.approx(0.2)
    # normalize (20) and ① (40), per batch; the copy in neither
    assert fuse == pytest.approx(0.03)
    assert (forward + fuse) * 2 * 1e3 == pytest.approx(
        TraceView(ev).kernels_us())


def test_a_replay_alone_is_read():
    ev = [e for e in _events() if e.id not in (2, 3)
          and e.name != "mspl.generate.model:a"]
    assert _read("forward_ms.sweep", ev) == pytest.approx(0.15)
    assert _read("fuse_ms.sweep", ev) == pytest.approx(0.03)


def test_no_model_spans_read_none():
    ev = [e for e in _events() if not e.name.startswith("mspl.")]
    assert _read("forward_ms.sweep", ev) is None
    assert _read("fuse_ms.sweep", ev) is None
    assert _read("forward_ms.sweep", []) is None
    assert _read("fuse_ms.sweep", []) is None
