"""One run of a cell: set-up, the measured window, the check, the
metrics, and the result line.

The driver named by the cell's traffic does the work (``setup``,
``window``, ``release``, ``reference``, ``outputs``, ``judge``); this
module times set-up, traces the window when asked, reads the peak
memory before the program's state is freed, runs the check after it,
and reads each per-layer metric with its reader.
"""
from __future__ import annotations

import json
import math
import sys
import time
from typing import Any, Dict, Optional, Tuple

import torch

from perfbench.lib import bench, inputs
from perfbench.lib import trace as tr
from perfbench.reference import models


def check(run, driver, st) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """The program's outputs against the fp32 reference's: each number
    beside its limit; correct where every number has a limit and is
    within it."""
    ref = driver.reference(run, st, mm=models.mm32)
    values = driver.judge(run, st, driver.outputs(run, st), ref)
    del ref
    checks, ok = {}, True
    for name, v in values.items():
        limit = run.cell.limits.get(name, {}).get("limit")
        checks[name] = {"value": v, "limit": limit}
        ok = ok and limit is not None and math.isfinite(v) and v <= limit
    return ok, checks


def readings(run, driver, st, with_control: bool = True
             ) -> Dict[str, Dict[str, float]]:
    """The program's numbers and, ``with_control``, the control's (the
    reference in float8 put in the program's place), each judged
    against one fp32 reference."""
    ref = driver.reference(run, st, mm=models.mm32)
    out = {"program": driver.judge(run, st, driver.outputs(run, st), ref)}
    if with_control:
        low = driver.reference(run, st, mm=models.mm8)
        out["control"] = driver.judge(run, st,
                                      driver.as_outputs(run, st, low), ref)
    return out


def measure(cell, seed: int, seconds: float, trace: bool, device,
            t_start: float, kernels: Any = None):
    """Set-up and the window; returns (run, driver, state, setup_s)."""
    cuda = device.type == "cuda"
    if cuda and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    run = bench.Run(cell, seed, seconds, trace, device)
    driver = bench.load_module("drivers", cell.traffic["driver"])
    if cuda:
        torch.cuda.set_device(device)
        torch.empty(0, device=device)       # the context, before its stats
        torch.cuda.reset_peak_memory_stats(device)
    st = driver.setup(run)
    inputs.sync(device)
    setup_s = time.perf_counter() - t_start
    before = dict(kernels.LAUNCHES) if kernels is not None else {}
    with tr.traced(trace and cuda) as box:
        w0 = time.time_ns()
        driver.window(run, st)
        inputs.sync(device)
        if box is not None:
            box.append(((w0, time.time_ns()), run.spans))
    if kernels is not None:
        run.counters["launches"] = {k: v - before.get(k, 0)
                                    for k, v in kernels.LAUNCHES.items()}
    if box:
        run.timeline = box[0]
    return run, driver, st, setup_s


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, kernels: Any = None) -> Optional[Dict[str, Any]]:
    """The result of one run, or None where a forbidden module was
    loaded once the window had closed."""
    run, driver, st, setup_s = measure(cell, seed, seconds, trace, device,
                                       t_start, kernels)
    if bench.forbidden_modules():
        return None
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    driver.release(run, st)
    correct, checks = check(run, driver, st)
    metrics: Dict[str, Dict[str, Any]] = {}
    if trace:
        for m in cell.per_layer:
            v = bench.load_module("metrics", m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(run.e2e, setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out: Dict[str, Any] = {"correct": bool(correct),
                           "attempted": run.attempted, "failed": run.failed,
                           "metrics": metrics, "device": dev}
    if run.timeline is not None:
        tl = run.timeline
        dev["busy_s"] = tl.busy_s()
        dev["window_s"] = tl.window_s
        out["breakdown"] = {"device_ops": tl.top_ops(10),
                            "idle_gaps": tl.idle_by_host(10)}
    out["checks"] = checks
    return out


def emit(result: Dict[str, Any]) -> None:
    """Each compared number beside its limit as the last lines on
    standard error, then the result as the last line on standard output,
    ``checks`` its last key."""
    for name, c in result["checks"].items():
        sys.stderr.write(f"check {name} = {c['value']!r} "
                         f"(limit {c['limit']!r})\n")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
