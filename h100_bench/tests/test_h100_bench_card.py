"""On a CUDA card: each cell of `BENCHMARK.json` runs a short window with
`correct` true, its end-to-end metrics in the untraced line and its
per-layer metrics in the traced one.  Skips without a card.

    python3 -m pytest -q -m card h100_bench/tests
"""

import json
import subprocess
import sys

import pytest

from h100_bench import common

CELLS = [w["name"] for w in common.load_json(
    common.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(card, cell, trace):
    out = subprocess.run(
        [sys.executable, str(common.HERE / "run.py"), "--workload", cell,
         "--seed", "4294967311", "--seconds", "4", "--trace", str(trace)],
        capture_output=True, text=True, timeout=1500)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    c = common.load_cell(cell)
    want = c.end_to_end if not trace else [m["name"] for m in c.per_layer]
    assert set(line["metrics"]) == set(want)
