"""The device timeline of a traced window, from ``torch.profiler``.

:class:`Timeline` holds every device activity (kernels, copies, fills)
with its start and end, and the harness's spans on the host.  Busy time
is the union of the device intervals (overlapping kernels count once);
the idle share is what the union leaves of the window.  Idle gaps are
named by what the host was doing when each began: the innermost of the
harness's spans running then (``score.call``: inside the program's call),
or ``(between calls)``.
"""
from __future__ import annotations

import bisect
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import torch

#: gaps shorter than this are launch spacing, not named
MIN_GAP_NS = 20_000


@dataclass
class Timeline:
    window: Tuple[int, int]                                  # ns
    device: List[Tuple[int, int, str]] = field(default_factory=list)
    host: List[Tuple[int, int, str]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def _clipped(self) -> List[Tuple[int, int]]:
        a, b = self.window
        return sorted((max(s, a), min(e, b)) for s, e, _ in self.device
                      if e > a and s < b)

    def busy_intervals(self) -> List[Tuple[int, int]]:
        out: List[List[int]] = []
        for s, e in self._clipped():
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def kernel_s(self, match) -> Tuple[float, int]:
        """(device seconds, launches) of the activities whose name
        ``match`` accepts, inside the window."""
        a, b = self.window
        t, n = 0, 0
        for s, e, name in self.device:
            if e > a and s < b and match(name):
                t += min(e, b) - max(s, a)
                n += 1
        return t / 1e9, n

    def top_ops(self, k: int = 10) -> List[List]:
        by: Dict[str, int] = {}
        a, b = self.window
        for s, e, name in self.device:
            if e > a and s < b:
                by[name] = by.get(name, 0) + min(e, b) - max(s, a)
        rows = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[_short(n), t / 1e9] for n, t in rows]

    def gaps(self) -> Iterator[Tuple[int, int]]:
        a, b = self.window
        at = a
        for s, e in self.busy_intervals():
            if s > at:
                yield at, s
            at = max(at, e)
        if b > at:
            yield at, b

    def idle_by_host(self, k: int = 10) -> List[List]:
        """Idle time summed by the host activity each gap began in, the
        ``k`` largest."""
        host = sorted(self.host)
        starts = [s for s, _, _ in host]
        by: Dict[str, int] = {}
        for s, e in self.gaps():
            if e - s < MIN_GAP_NS:
                by["(gaps under 20 us)"] = by.get("(gaps under 20 us)", 0) \
                    + e - s
                continue
            name = "(between calls)"
            i = bisect.bisect_right(starts, s)
            best = None
            for j in range(i - 1, max(-1, i - 400), -1):
                hs, he, hn = host[j]
                if hs <= s < he and (best is None or hs > best[0]):
                    best = (hs, hn)
            if best is not None:
                name = best[1]
            by[name] = by.get(name, 0) + e - s
        rows = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[_short(n), t / 1e9] for n, t in rows]


def _short(name: str, n: int = 120) -> str:
    name = " ".join(name.split())
    return name if len(name) <= n else name[:n - 3] + "..."


def from_profile(prof, window: Tuple[int, int],
                 host: List[Tuple[int, int, str]]) -> Timeline:
    """The device activity of a finished ``torch.profiler.profile`` that
    traced the device alone; ``window`` and the ``host`` spans in the
    same clock (ns since the epoch, the profiler's)."""
    device = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            s = ev.start_ns()
            device.append((s, s + ev.duration_ns(), ev.name()))
    tl = Timeline(window, device, list(host))
    if device and not tl.busy_intervals():
        raise RuntimeError("no device activity inside the window: the "
                           "profiler's clock is not the host's epoch clock")
    return tl


@contextmanager
def traced(enabled: bool) -> Iterator[Optional[list]]:
    """Traces the device during the block when ``enabled`` (the host is
    not traced: per-operator host tracing slowed a training window from
    36 to 30 steps of qwen1.5-4B on one H100).  Yields a list; the caller appends ``(window, host
    spans)`` in epoch ns before the block ends, and finds the
    :class:`Timeline` in it afterwards (None when not traced)."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    box: list = []
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    try:
        yield box
    finally:
        torch.cuda.synchronize()
        prof.stop()
    window, host = box.pop()
    box.append(from_profile(prof, window, host))
