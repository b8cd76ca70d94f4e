"""On the card: each cell's command end to end at its own size, with a
short window, comes out correct with every metric it names.

    PYTHONPATH=src python -m pytest -q -m cuda perfbench/tests/test_perfbench_chip.py
"""
import json
import subprocess
import sys

import pytest

from perfbench.lib import bench

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.parametrize("name", [w["name"] for w in
                                  bench.load_benchmark()["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_pb_cell_runs_correct_on_the_card(card, name, trace):
    cell = bench.load_cell(name)
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          name, "--seed", "2718281828", "--seconds", "3",
                          "--trace", str(trace)], cwd=bench.ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    want = cell.per_layer if trace else cell.end_to_end
    assert set(res["metrics"]) <= {m["name"] for m in want}
    if not trace:
        assert set(res["metrics"]) == {m["name"] for m in want}
    else:
        assert res["device"]["busy_s"] > 0
