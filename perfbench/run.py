"""Runs one cell of the benchmark of the PyTorch and CUDA port and prints
its result as the last line of standard output.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout: the cell's configuration, traffic and
limits are the files ``BENCHMARK.json`` names (``perfbench/lib/bench.py``).
Set-up (imports, the kernel library's load or first build, the weights
drawn on the card, the warm calls) ends at the first timed call; then
the driver runs its traffic for ``--seconds`` (``--trace 1``: under
``torch.profiler``, and the per-layer metrics are read from that run);
then the program's state is freed and the check compares what the window
produced with the plain reference.  Exit codes: 0 a result was printed
(``correct`` may be false), 2 a bad argument or a file missing, 3 no
card or too few, 4 JAX or the JAX package was loaded, 5 the program
could not be imported.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _env() -> None:
    """Build and kernel caches at fixed paths inside the checkout; no
    library of the run may load JAX by itself."""
    build = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build /
                                                      "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def fail(code: int, msg: str) -> None:
    sys.stderr.write(f"perfbench: {msg}\n")
    sys.stderr.flush()
    sys.exit(code)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    _env()
    try:
        from perfbench.lib import bench
        cell = bench.load_cell(a.workload)
    except (OSError, KeyError, ValueError) as e:
        fail(2, f"cannot load workload {a.workload!r}: {e!r}")
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        fail(3, f"{cell.name} needs {cell.chips} CUDA device(s); "
                f"found {torch.cuda.device_count()}")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
        from repro_torch import kernels
    except ImportError as e:
        fail(5, f"the program (repro_torch) cannot be imported: {e!r}")
    from perfbench.lib import harness
    result = harness.run_cell(cell, a.seed, a.seconds, bool(a.trace),
                              torch.device("cuda", 0), T_START, kernels)
    if result is None:
        fail(4, "a forbidden module was loaded: " +
                ", ".join(bench.forbidden_modules()))
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
