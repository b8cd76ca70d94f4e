"""The correctness check's two readings, on the chip at a cell's own
size: for each seed, the program's numbers and the control's (the
reference computed with float8 products put in the program's place),
each judged against the fp32 reference; or, with ``--fault``, the
numbers of the program with that fault planted under the timed path
(``perfbench/lib/faults.py``).  One JSON line a seed.

    python3 perfbench/control.py --workload <name> --seconds 3 \\
        --seeds 11 12 13 [--fault <name>]

The benchmark's own runs do not run this; the limits in
``perfbench/limits/`` were set from its readings.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--fault")
    a = ap.parse_args(argv)
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels

    from perfbench.lib import bench, faults, harness
    cell = bench.load_cell(a.workload)
    dev = torch.device("cuda", 0)
    for seed in a.seeds:
        t0 = time.perf_counter()
        ctx = faults.planted(a.fault) if a.fault else contextlib.nullcontext()
        with ctx:
            run, driver, st, _ = harness.measure(cell, seed, a.seconds, False,
                                                 dev, t0, kernels)
        driver.release(run, st)
        line = {"workload": a.workload, "seed": seed, "fault": a.fault,
                **harness.readings(run, driver, st, not a.fault)}
        del st
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
