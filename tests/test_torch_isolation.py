"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on the card unless the caller asks for the CPU."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _absolute_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(mod):
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _absolute_imports(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_port_imports_with_jax_blocked():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None\n"
            "import repro_torch.core, repro_torch.core.columnar\n"
            "import repro_torch.kernels.phash.ops, repro_torch.kernels.pkval.ops\n"
            "import repro_torch.kernels.hintchain.ops\n"
            "import repro_torch.models, repro_torch.serve, repro_torch.configs\n"
            "import repro_torch.kernels.flash_attention.ops\n"
            "import repro_torch.kernels.mamba2_ssd.ops\n"
            "import repro_torch.kernels.rwkv6_scan.ops\n"
            "import repro_torch.kernels.moe_gmm.ops\n"
            "import repro_torch.core.cluster_sim, repro_torch.core.costmodel\n"
            "import repro_torch.metaplane, repro_torch.ckpt, repro_torch.data\n"
            "import repro_torch.runtime\n"
            "print(len(repro_torch.core.__all__))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 50


def test_entry_points_default_to_cuda(monkeypatch):
    from repro_torch.core import MetadataStore
    from repro_torch.core.columnar import ColumnarMetadataStore
    from repro_torch.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (ColumnarMetadataStore, MetadataStore,
                 lambda: ColumnarMetadataStore(device="cuda")):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make()
    store = ColumnarMetadataStore(device="cpu")
    assert store.device == torch.device("cpu")
    assert resolve_device("cpu").type == "cpu"


def _run_smoke(cwd):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the smoke test would run")
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_refuses_outside_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
