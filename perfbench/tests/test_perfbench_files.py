"""The benchmark's files: ``BENCHMARK.json`` against the rules it is
written to, every file it names present, and a new configuration, model
family, traffic mix and per-layer metric found by name from new files
alone."""
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from perfbench.lib import bench
from perfbench.reference import layout

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def spec():
    return bench.load_benchmark()


def test_pb_benchmark_keys_and_names(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["perfbench"]
    assert 1 <= spec["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in spec[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert "setup_s" in {m["name"] for m in spec["end_to_end"]}
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in {"host_clock", "device_trace"}
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 0 < len(w["why"]) <= 200


@pytest.mark.parametrize("kind", ["configs", "workloads", "per_layer"])
def test_pb_every_named_file_exists(spec, kind):
    for x in spec[kind]:
        if kind == "configs":
            assert (bench.ROOT / x["file"]).is_file()
            assert x["file"].startswith("perfbench/")
        elif kind == "workloads":
            c = bench.load_cell(x["name"], spec)
            assert (bench.HERE / "drivers" /
                    f"{c.traffic['driver']}.py").is_file()
            assert c.limits, "every cell's numbers have limits"
            assert {m["name"] for m in c.end_to_end} > {"setup_s"}
            assert c.per_layer
        else:
            assert callable(bench.load_module("metrics", x["name"]).read)
            assert x["moves"] in {m["name"] for m in spec["end_to_end"]}


def test_pb_configs_hold_their_published_sizes(spec):
    for c in spec["configs"]:
        f = json.loads((bench.ROOT / c["file"]).read_text())
        assert f["reduced"] == c["reduced"] and f["source"] == c["source"]
        n = sum(int(__import__("math").prod(leaf.shape))
                for leaf in layout.leaves(f["model"]))
        assert n == f["parameters"], c["name"]


RUN_NEW_CELL = """
import json, sys, time
sys.path[:0] = [{root!r}, {src!r}]
import torch
from perfbench.lib import bench, harness
from repro_torch import kernels
out = harness.run_cell(bench.load_cell("tiny_dense.score-tiny"), 5, 0.2,
                       True, torch.device("cpu"), time.perf_counter(),
                       kernels)
fam = sys.modules["perfbench.reference.families.tiny_family"]
print(json.dumps({{"correct": out["correct"], "metrics": out["metrics"],
                  "family": fam.__file__}}))
"""


def test_pb_new_cell_metric_and_mix_found_by_name(tmp_path, spec):
    """A throwaway configuration, model family, traffic mix and metric:
    files and entries only, no existing file changed; the new cell runs
    end to end on the CPU at a tiny size from that checkout."""
    shutil.copytree(bench.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    here = tmp_path / "perfbench"
    fams = here / "reference" / "families"
    shutil.copy(fams / "dense.py", fams / "tiny_family.py")
    cfg = json.loads((here / "configs" / "qwen1_5_4b.json").read_text())
    cfg["name"] = "tiny_dense"
    cfg["model"].update(n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
                        d_ff=64, vocab_size=128, reference="tiny_family")
    (here / "configs" / "tiny_dense.json").write_text(json.dumps(cfg))
    (here / "traffic" / "score-tiny.json").write_text(json.dumps(
        {"driver": "score", "batch": 1, "seq": 8, "warm_calls": 0,
         "check_calls": 1, "check_rows": 1}))
    (here / "limits" / "tiny_dense.score-tiny.json").write_text(json.dumps(
        {"logits_rel_err_max": {"limit": 0.5}}))
    (here / "metrics" / "calls.tiny.py").write_text(
        "def read(run):\n    return float(len(run.calls)) or None\n")
    new = json.loads(json.dumps(spec))
    new["configs"].append({"name": "tiny_dense", "source": "test",
                           "file": "perfbench/configs/tiny_dense.json",
                           "reduced": [], "why": "test"})
    new["workloads"].append({"name": "tiny_dense.score-tiny",
                             "config": "tiny_dense", "traffic": "score-tiny",
                             "chips": 1, "why": "test"})
    new["end_to_end"][0].setdefault("workloads", []).append(
        "tiny_dense.score-tiny")
    new["per_layer"].append({"name": "calls.tiny", "unit": "calls",
                             "better": "higher", "source": "program_span",
                             "layer": "test", "moves": new["end_to_end"][0][
                                 "name"],
                             "workloads": ["tiny_dense.score-tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    c = bench.load_cell("tiny_dense.score-tiny", root=tmp_path)
    assert c.model["d_model"] == 32 and c.traffic["seq"] == 8
    assert c.limits["logits_rel_err_max"]["limit"] == 0.5
    assert [m["name"] for m in c.per_layer] == ["calls.tiny"]
    reader = bench.load_module("metrics", "calls.tiny", root=tmp_path)
    run = bench.Run(c, 1, 0.1, False, None, calls=[{}, {}])
    assert reader.read(run) == 2.0
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = RUN_NEW_CELL.format(root=str(tmp_path),
                               src=str(bench.ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, text=True, capture_output=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["family"] == str(fams / "tiny_family.py")
    assert got["correct"] and got["metrics"]["calls.tiny"]["value"] >= 1
