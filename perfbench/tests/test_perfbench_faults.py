"""The check has to fail what it must: a run driven past the look for a
chip (on the CPU, at the smoke sizes) with a fault planted under the
timed path comes out not correct, and so does the control, the
reference computed with float8 products in the program's place, against
each cell's limits.  Also: no result without a card, none in a checkout
without the program, none once a forbidden module was loaded."""
import os
import shutil
import subprocess
import sys
import time

import pytest

from perfbench.lib import bench, faults, harness
from perfbench_smoke import CPU, cell, control_cell

CELLS = ["rwkv6_3b.score-4k", "qwen1_5_4b.train-2k"]
FAULTS = [("rwkv6_3b.score-4k", "answer_altered"),
          ("qwen1_5_4b.train-2k", "state_unchanged"),
          ("qwen1_5_4b.train-2k", "half_batch")]


def _kernels():
    from repro_torch import kernels
    return kernels


@pytest.mark.parametrize("name,fault", FAULTS)
def test_pb_planted_fault_is_not_correct(name, fault, monkeypatch):
    # other test files of this worker may have loaded JAX; what a run
    # loads is held by test_perfbench_isolation.py in a process of its own
    monkeypatch.setattr(bench, "forbidden_modules", lambda: [])
    with faults.planted(fault):
        out = harness.run_cell(cell(name), 7, 0.3, False, CPU,
                               time.perf_counter(), _kernels())
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_pb_control_fails_a_limit(name):
    c = control_cell(name)
    run, driver, st, _ = harness.measure(c, 8, 0.3, False, CPU,
                                         time.perf_counter(), _kernels())
    driver.release(run, st)
    got = harness.readings(run, driver, st)["control"]
    assert set(got) == set(c.limits)
    assert any(v > c.limits[k]["limit"] for k, v in got.items()), got


def test_pb_no_result_once_a_forbidden_module_is_loaded(monkeypatch):
    monkeypatch.setattr(bench, "forbidden_modules", lambda: ["jax"])
    assert harness.run_cell(cell("rwkv6_3b.score-4k"), 1, 0.1, False, CPU,
                            time.perf_counter(), _kernels()) is None


ARGS = ["--workload", "rwkv6_3b.score-4k", "--seed", "3000000001",
        "--seconds", "1", "--trace", "0"]


def _run(where):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""                  # no card, even there
    return subprocess.run([sys.executable, "perfbench/run.py"] + ARGS,
                          cwd=where, env=env, capture_output=True, text=True,
                          timeout=300)


def test_pb_no_card_no_result():
    out = _run(bench.ROOT)
    assert out.returncode == 3 and out.stdout.strip() == ""


def test_pb_checkout_without_the_program_gives_no_result(tmp_path):
    shutil.copy(bench.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(bench.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
