"""Arithmetic of the readers of the program's spans.

The program records its phases while the traced window's profiler runs
(``repro_torch.spans``): each span's host interval in the epoch ns of
the :class:`~perfbench.lib.trace.Timeline`, and, on the card, two marks
in the trace itself, between which lies its device interval on the
trace's own clock.  Two readings of a span's name, each a share (%) of
the window:

- device share: the union of device activity inside the union of its
  spans' device intervals (an activity under two spans counts once);
- idle share: the idle time of every gap of the window, whatever its
  length, that began while one of its spans was open on the host.  It
  is read on the trace's clock alone: a gap begins where the card has
  run all the host has launched, so one that begins inside a span's
  device interval (its first mark run, its second not yet launched)
  began while the host was inside the span.  The host's own clock is
  not compared with the trace's, which can run tens of ms apart.

A reading is None where the run was not traced, no span of the name was
recorded (a program that records none, as before ``repro_torch.spans``)
or none of them has a device interval.
"""
from __future__ import annotations

import bisect
from typing import Iterable, List, Optional, Sequence, Tuple

from perfbench.lib.trace import Timeline


def program_spans(run) -> list:
    """The spans the program recorded in the traced window's profiler
    session, each with its device interval from the window's trace."""
    try:
        from repro_torch import spans
    except ImportError:
        return []
    return spans.on_card(spans.recorded(), run.timeline.device)


def _merged(tl: Timeline, intervals: Iterable[Tuple[int, int]]
            ) -> List[Tuple[int, int]]:
    """``intervals`` clipped to the window and merged where they meet."""
    return Timeline(tl.window, [(s, e, "") for s, e in intervals]
                    ).busy_intervals()


def _named(run, name: str, recorded: Optional[Sequence]):
    tl = run.timeline
    if tl is None or not tl.window_s:
        return None, []
    got = program_spans(run) if recorded is None else recorded
    mine = [s for s in got if s.name == name]
    if not any(s.device for s in mine):
        return None, []
    return tl, mine


def device_share(run, name: str, recorded: Optional[Sequence] = None
                 ) -> Optional[float]:
    tl, mine = _named(run, name, recorded)
    if tl is None:
        return None
    marks = _merged(tl, (s.device for s in mine if s.device))
    busy = tl.busy_intervals()
    i = j = 0
    t = 0
    while i < len(busy) and j < len(marks):
        s = max(busy[i][0], marks[j][0])
        e = min(busy[i][1], marks[j][1])
        t += max(0, e - s)
        if busy[i][1] < marks[j][1]:
            i += 1
        else:
            j += 1
    return 100 * t / (tl.window[1] - tl.window[0])


def idle_share(run, name: str, recorded: Optional[Sequence] = None
               ) -> Optional[float]:
    tl, mine = _named(run, name, recorded)
    if tl is None:
        return None
    marks = _merged(tl, (s.device for s in mine if s.device))
    starts = [s for s, _ in marks]
    t = 0
    for s, e in tl.gaps():
        k = bisect.bisect_right(starts, s) - 1
        if k >= 0 and s < marks[k][1]:
            t += e - s
    return 100 * t / (tl.window[1] - tl.window[0])
