"""Spans of the program's phases, recorded while ``torch.profiler`` runs.

``with span("train.forward", where): ...`` marks a phase.  It records
only while a profiler session is running (``torch.autograd.profiler``'s
flag, set by the profiler's ``start()`` and cleared by its ``stop()``):
the program has no switch of its own, and an operator sees its spans by
running the job under ``torch.profiler`` and reading :func:`recorded`.
Off, a span costs one attribute read and a branch: no clock is read,
nothing is launched on the card, nothing is stored.

A recorded span keeps its id, its parent's (the innermost span open
when it began, on its thread), its root's (the step or call it belongs
to), its name and its host start and end (``time.time_ns``: ns since the
epoch, the clock the profiler's device timestamps are on).  Where
``where`` (a tensor or a device) is on the card, it also puts a mark on
the current stream at its start and at its end: an empty kernel of the
port's library (``kernels/csrc/span_marks.cu``), numbered from 0 in the
session in the order it was launched and named by its number modulo
:data:`MARKS` (``span_mark<k>`` in the trace).  The marks are activities
of the profiler's own trace, so the span's device interval, from the end
of its first mark to the start of its second, is on the clock of the
kernels it holds: :func:`on_card` reads it from the trace.  (CUDA events
mapped to the host's clock were tried first: the trace's clock ran up to
~110 ms behind the host's on one H100 host.)  The profiler may lose the
first or last records of a session, and may stamp a few of them out of
their order; the marks' names let :func:`on_card` number each mark it
finds all the same.

The record holds the latest session's spans: the module counts the
profiler's starts (it chains ``torch.autograd.profiler``'s
``_run_on_profiler_start``, the hook that sets the flag), and a
session's first recorded span clears the record of the one before and
numbers the marks from 0 again.

The spans: ``train.step`` (``train/step.py`` ``train_step_fn``, a root)
over ``train.forward`` (the loss of a microbatch), ``train.backward``
(``torch.autograd.grad``, the layers recomputed under remat) and
``train.optimizer`` (AdamW with the gradient's norm); ``lm.forward``
(``models/lm.py`` ``forward``, a root of a scoring call) over ``lm.head``
(``_logits``: the LM head alone, which remat never recomputes).
"""
from __future__ import annotations

import ctypes
import dataclasses
import itertools
import re
import threading
import time
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Any, Iterable, List, Optional, Sequence, Tuple

import torch
from torch.autograd import profiler as _profiler

#: classes of marks, one kernel each: ``SPAN_MARKS`` of ``span_marks.cu``
MARKS = 16
#: a mark's kernel in the profiler's trace (``void spans::span_mark<k>()``),
#: with its class
MARK = re.compile(r"\bspan_mark<(\d+)>")


@dataclass
class Span:
    id: int
    parent: Optional[int]
    root: int
    name: str
    start_ns: int
    end_ns: int = 0
    #: the numbers of its marks in the session, at the start and at the
    #: end; None where the work ran on the host
    marks: Optional[Tuple[int, int]] = None
    #: (start, end) on the card in the trace's ns, set by :func:`on_card`
    device: Optional[Tuple[int, int]] = None


_OFF = nullcontext()
_ids = itertools.count(1)
_marks = itertools.count()
_local = threading.local()
_mu = threading.Lock()
_record: List[Span] = []
#: profiler sessions started so far, and the one the record holds
_sessions = 0
_recording = 0


def _on_profiler_start(started=_profiler._run_on_profiler_start) -> None:
    global _sessions
    _sessions += 1
    started()


_profiler._run_on_profiler_start = _on_profiler_start


def _stack() -> List[Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


_lib: Optional[ctypes.CDLL] = None


def _launch_mark(k: int) -> None:
    """Launches the mark of class ``k`` on the current stream."""
    global _lib
    if _lib is None:
        from .kernels import _build
        lib = _build.library()
        lib.launch_span_mark.argtypes = [ctypes.c_int, ctypes.c_void_p]
        _lib = lib
    stream = torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())
    if _lib.launch_span_mark(k, stream):
        raise RuntimeError("launch_span_mark: CUDA error at launch")


def _mark() -> int:
    n = next(_marks)
    _launch_mark(n % MARKS)
    return n


class _Recording:
    __slots__ = ("name", "where", "span", "card")

    def __init__(self, name: str, where: Any) -> None:
        self.name, self.where = name, where

    def __enter__(self) -> Span:
        global _recording, _marks
        stack = _stack()
        dev = getattr(self.where, "device", self.where)
        self.card = dev is not None and torch.device(dev).type == "cuda"
        sid = next(_ids)
        up = stack[-1] if stack else None
        self.span = Span(sid, up.id if up else None,
                         up.root if up else sid, self.name, time.time_ns())
        with _mu:
            if _recording != _sessions:
                _record.clear()
                _marks = itertools.count()
                _recording = _sessions
            _record.append(self.span)
        if self.card:
            self.span.marks = (_mark(), -1)
        stack.append(self.span)
        return self.span

    def __exit__(self, *exc) -> None:
        s = self.span
        if self.card:
            s.marks = (s.marks[0], _mark())
        s.end_ns = time.time_ns()
        _stack().pop()


def span(name: str, where: Any = None):
    """A context marking a phase named ``name``; ``where`` (a tensor or a
    device) says whether its work runs on the card.  A shared no-op
    context unless a profiler session is running."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Recording(name, where)


def recorded() -> List[Span]:
    """The spans of the latest profiler session, in the order they began.
    A plain read: it waits for nothing and may be called at any time."""
    with _mu:
        return list(_record)


def on_card(spans: Sequence[Span],
            activities: Iterable[Tuple[int, int, str]]) -> List[Span]:
    """``spans``, one session's, with the device intervals that the
    profiler's trace of the session gives them.  ``activities`` are the
    trace's device activities, ``(start_ns, end_ns, name)``.

    Its marks are taken in the order they ran, and each is numbered as
    the number of its class nearest to where the mark before it puts
    it: the first holds its class's own number (the trace lost fewer than
    :data:`MARKS` marks at its start), and fewer than half of
    :data:`MARKS` lost or displaced in a row do not move the others.  A
    span whose marks the trace lost, or stamped out of their order, gets
    no interval."""
    seen = sorted((s, e, int(m.group(1))) for s, e, name in activities
                  if (m := MARK.search(name)))
    launched = 1 + max((s.marks[1] for s in spans if s.marks), default=-1)
    at = {}
    shift = seen[0][2] if seen else 0       # number less rank
    for rank, (s, e, k) in enumerate(seen):
        guess = rank + shift
        n = guess + (k - guess + MARKS // 2) % MARKS - MARKS // 2
        shift = n - rank
        if 0 <= n < launched:
            at.setdefault(n, (s, e))
    out = []
    for s in spans:
        a, b = s.marks or (-1, -1)
        if a in at and b in at and at[a][1] <= at[b][0]:
            s = dataclasses.replace(s, device=(at[a][1], at[b][0]))
        out.append(s)
    return out
