"""What a run loads: no top-level ``jax``, ``jaxlib``, ``flax`` or
``repro`` module in a process that imports the harness and drives the
program, compared by whole top-level names; and nothing of the program
in the reference."""
import json
import os
import subprocess
import sys

from perfbench.lib import bench

HARNESS = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
import perfbench.run, perfbench.control
from perfbench.lib import bench, harness, inputs, readers, trace, work, faults
from perfbench.reference import families, layout, models, train
for kind in ("drivers", "metrics"):
    for f in sorted((bench.HERE / kind).glob("*.py")):
        if f.stem != "__init__":
            bench.load_module(kind, f.stem)
for f in sorted((bench.HERE / "reference" / "families").glob("*.py")):
    if f.stem != "__init__":
        families.load({{"reference": f.stem}})
{extra}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

DRIVE = """
import torch
import repro_torch
from repro_torch.models import forward
c = bench.load_cell("rwkv6_3b.score-4k")
c.config["model"].update(n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
                         d_ff=64, vocab_size=64, rwkv_head_dim=16)
from perfbench.lib import inputs
p = layout.make_params(c.model, 1, "cpu")
forward(p, {"tokens": torch.zeros(1, 8, dtype=torch.int32)},
        cfg=inputs.program_config(c.model), use_kernels=True, device="cpu")
"""

REFERENCE = """
import json, sys
sys.path[:0] = [{root!r}]
import perfbench.reference.layout, perfbench.reference.models
import perfbench.reference.train
from perfbench.reference import families
for name in ("dense", "rwkv6"):
    families.load({{"reference": name}})
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _tops(code: str) -> set:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                         capture_output=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _fmt(code: str, extra: str = "") -> str:
    return code.format(root=str(bench.ROOT), src=str(bench.ROOT / "src"),
                       extra=extra)


def test_pb_harness_and_program_load_no_jax():
    tops = _tops(_fmt(HARNESS, DRIVE))
    assert "repro_torch" in tops and "perfbench" in tops
    assert not tops & set(bench.FORBIDDEN), tops & set(bench.FORBIDDEN)


def test_pb_reference_imports_nothing_of_the_program():
    tops = _tops(_fmt(REFERENCE))
    assert not tops & ({"repro_torch"} | set(bench.FORBIDDEN))


def test_pb_forbidden_names_compare_whole(monkeypatch):
    fake = {"repro_torch.models": sys, "jaxtyping": sys, "flax_like": sys,
            "repro.core.fs": sys}
    monkeypatch.setattr(sys, "modules", fake)
    assert bench.forbidden_modules() == ["repro"]
