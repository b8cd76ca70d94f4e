"""Arithmetic the per-layer readers share.  A reader returns None where
its run holds nothing to read (no trace, no launch of its kernel); it
never returns 0 for a share of a roofline or of a peak."""
from __future__ import annotations

from typing import Callable, Optional, Tuple

from perfbench.lib import work


def mfu_window(run) -> Optional[float]:
    """Model FLOPs of the window's calls over the window's time, as a
    share (%) of the chips' bf16 peak."""
    flops = sum(c["flops"] for c in run.calls)
    if not flops or not run.window_s:
        return None
    return 100 * flops / run.window_s / (run.cell.chips *
                                         work.PEAK_FLOPS["bfloat16"])


def idle_share(run) -> Optional[float]:
    """The share (%) of the traced window in which no device activity
    ran (the union of the device intervals against the window)."""
    tl = run.timeline
    if tl is None or not tl.window_s:
        return None
    return 100 * (1 - tl.busy_s() / tl.window_s)


def roofline(run, counter: str, match: Callable[[str], bool],
             launch_work: Callable[[dict, int, int], Tuple[float, float]]
             ) -> Optional[float]:
    """Σ of the kernel's least times over its device time in the traced
    window, as a share (%).  The launches a call makes are the program's
    launch counter over the window's calls; each launch of a call is
    counted at that call's shape (``launch_work(model, B, S)``: bytes,
    operations)."""
    tl = run.timeline
    launches = run.counters.get("launches", {}).get(counter, 0)
    if tl is None or not launches or not run.calls:
        return None
    dev_s, _ = tl.kernel_s(match)
    if not dev_s:
        return None
    per_call = launches / len(run.calls)
    m = run.cell.model
    least = 0.0
    for c in run.calls:
        n_bytes, flops = launch_work(m, c["B"], c["S"])
        least += per_call * work.bound_s(n_bytes, flops, m["dtype"])[0]
    return 100 * least / dev_s


def is_flash(name: str) -> bool:
    return "flash" in name


def is_wkv(name: str) -> bool:
    return "wkv" in name or "scan_pass" in name
