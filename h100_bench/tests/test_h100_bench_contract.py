"""`BENCHMARK.json` against the contract: names, units, keys, that every
cell's files are found by name, that each per-layer metric's cells report
the metric it moves, and that the run length fits the check's time."""

import json
import re
import subprocess
import sys

import pytest

from h100_bench import common, program

BENCH = common.load_json(common.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["h100_bench"]
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(TEXT.match(w) for w in BENCH["command"])
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_and_units():
    names = []
    for c in BENCH["configs"]:
        names.append(c["name"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        if m in BENCH["per_layer"]:
            assert TEXT.match(m["layer"])
            assert m["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
        else:
            assert m["source"] in ("device_trace", "host_clock")
            assert 0.01 <= m["bound"] <= 0.25
    names += CELLS + [m["name"] for m in metrics]
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))


def test_setup_metric_in_every_cell():
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and "workloads" not in setup[0]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = common.load_cell(cell)
    assert (common.HERE / "drivers" / f"{c.traffic['driver']}.py").exists()
    for m in c.per_layer:
        assert (common.HERE / "metrics" / f"{m['name']}.py").exists()
    assert set(c.limits) >= {"launch_excess"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    # each kernel whose launches the limits expect has its counter
    counters = program.launch_counters(c.launches)
    assert all(hasattr(fn, "launches") for fn in counters.values())


@pytest.mark.parametrize("cell", CELLS)
def test_moves_reported_where_listed(cell):
    e2e = common.load_cell(cell).end_to_end
    for m in BENCH["per_layer"]:
        if cell in m.get("workloads", []):
            assert m["moves"] in e2e, (m["name"], cell)


def test_run_seconds_fit_the_check():
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    cells = 24
    total = (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, str(common.HERE / "run.py"), "--workload", CELLS[0],
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
