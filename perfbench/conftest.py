"""pytest settings for the benchmark's own tests: the ``cuda`` marker
(tests that need the card decide in a fixture whether to skip); JAX is
never imported here."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card and nvcc (the port's kernels)")
