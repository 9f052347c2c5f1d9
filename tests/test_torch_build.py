"""The library names of the port's CUDA build (`mspl_tpu_torch/ops/_cuda.py`)
on the CPU: a library is rebuilt when its source or a header that it
includes changes, and only then.  Nothing is compiled here."""

import pytest

from mspl_tpu_torch.ops import _cuda


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    files = {
        "common.cuh": "#pragma once\n",
        "fused.cuh": '#pragma once\n#include "common.cuh"\n',
        "fused.cu": '#include "fused.cuh"\n',
        "fused_mixed.cu": '#include "fused.cuh"\n',
        "other.cu": '#include "common.cuh"\n',
    }
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    return tmp_path


def test_inputs_follow_includes(csrc):
    names = lambda n: sorted(p.name for p in _cuda._inputs(n))  # noqa: E731
    assert names("fused") == ["common.cuh", "fused.cu", "fused.cuh"]
    assert names("fused_mixed") == ["common.cuh", "fused.cuh",
                                    "fused_mixed.cu"]
    assert names("other") == ["common.cuh", "other.cu"]


@pytest.mark.parametrize("edited,renamed", [
    ("fused.cuh", {"fused", "fused_mixed"}),
    ("common.cuh", {"fused", "fused_mixed", "other"}),
    ("other.cu", {"other"}),
])
def test_an_edit_renames_only_its_libraries(csrc, edited, renamed):
    libs = ("fused", "fused_mixed", "other")
    before = {n: _cuda.lib_path(n) for n in libs}
    with open(csrc / edited, "a") as f:
        f.write("// edited\n")
    after = {n: _cuda.lib_path(n) for n in libs}
    assert {n for n in libs if after[n] != before[n]} == renamed


def test_the_port_sources_resolve():
    """Every source of the build and each header it names exist."""
    for name in _cuda.SOURCES:
        inputs = _cuda._inputs(name)
        assert inputs[0].name == f"{name}.cu"
        assert all(p.exists() for p in inputs)
