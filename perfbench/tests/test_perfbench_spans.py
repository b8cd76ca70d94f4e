"""The readers of the program's spans (``perfbench/lib/spans.py`` and the
seven metrics that read it) on synthetic timelines and span lists:
nested and back-to-back spans, the idle parts adding up to the idle
share, no device interval counted twice, and None where there is
nothing to read."""
import random
import sys
from types import SimpleNamespace

import pytest

from perfbench.lib import bench, readers, spans
from perfbench.lib.trace import Timeline

PHASES = ("train.forward", "train.backward", "train.optimizer")
READERS = {"head_share.score": "lm.head",
           "forward_share.train": "train.forward",
           "backward_share.train": "train.backward",
           "optimizer_share.train": "train.optimizer",
           "forward_idle.train": "train.forward",
           "backward_idle.train": "train.backward",
           "optimizer_idle.train": "train.optimizer"}


def _span(name, host, device=None):
    return SimpleNamespace(name=name, start_ns=host[0], end_ns=host[1],
                           device=device)


def _run(window, device):
    return SimpleNamespace(timeline=Timeline(window, [
        (s, e, "k") for s, e in device]))


def test_pb_device_share_of_nested_and_back_to_back_spans():
    run = _run((0, 100), [(10, 30), (25, 40), (50, 60), (70, 90), (95, 120)])
    rec = [_span("a", (0, 50), (0, 35)), _span("a", (5, 40), (20, 45)),
           _span("b", (50, 60), (45, 65)), _span("b", (60, 99), (65, 80)),
           _span("c", (99, 100), (92, 130))]
    # a: its union (0, 45) holds the busy (10, 40); b: (45, 80) holds
    # (50, 60) and (70, 80); c: inside the window only
    assert spans.device_share(run, "a", rec) == pytest.approx(30.0)
    assert spans.device_share(run, "b", rec) == pytest.approx(20.0)
    assert spans.device_share(run, "c", rec) == pytest.approx(5.0)


def test_pb_idle_share_reads_the_trace_clock_alone():
    """A gap belongs to the span whose device interval it begins in, where
    the host's clock may say otherwise: here the host's clock runs 40 ns
    ahead of the trace's."""
    run = _run((0, 100), [(0, 10), (20, 30), (60, 70)])
    rec = [_span("a", (40, 90), (0, 50)), _span("b", (90, 140), (50, 100))]
    # a: the gaps (10, 20) and (30, 60); b: (70, 100)
    assert spans.idle_share(run, "a", rec) == pytest.approx(40.0)
    assert spans.idle_share(run, "b", rec) == pytest.approx(30.0)


def _steps(seed, n=12):
    """A window of ``n`` steps: each step's three phases back to back on
    the host, a pause between steps, and kernels queued at random."""
    rng = random.Random(seed)
    rec, t = [], 1_000
    for _ in range(n):
        for name in PHASES:
            d = rng.randrange(5_000, 50_000)
            rec.append(_span(name, (t, t + d), (t + 300, t + d + 300)))
            t += d
        t += rng.randrange(0, 20_000)
    device, at = [], 0
    while at < t:
        at += rng.randrange(0, 3_000)
        d = rng.randrange(100, 8_000)
        device.append((at, at + d))
        at += d
    return _run((0, t + 5_000), device), rec


@pytest.mark.parametrize("seed", range(3))
def test_pb_idle_parts_add_up_to_the_idle_share(seed):
    run, rec = _steps(seed)
    parts = [spans.idle_share(run, name, rec) for name in PHASES]
    phases = sorted(s.device for s in rec)
    window = run.timeline.window[1] - run.timeline.window[0]
    outside = 100 * sum(e - s for s, e in run.timeline.gaps()
                        if not any(a <= s < b for a, b in phases)) / window
    assert all(p > 0 for p in parts)
    assert sum(parts) + outside == pytest.approx(readers.idle_share(run),
                                                 abs=1e-9)


@pytest.mark.parametrize("seed", range(3))
def test_pb_phase_device_shares_count_no_interval_twice(seed):
    run, rec = _steps(seed)
    busy = 100 - readers.idle_share(run)
    shares = [spans.device_share(run, name, rec) for name in PHASES]
    assert sum(shares) <= busy + 1e-9
    # the phases' device intervals laid end to end over the whole window,
    # one of them twice over: the shares then add up to the busy share
    a, b = run.timeline.window
    cut = [a, a + (b - a) // 3, a + 2 * (b - a) // 3, b]
    tiled = [_span(n, (0, 1), (cut[i], cut[i + 1]))
             for i, n in enumerate(PHASES)]
    tiled.append(_span(PHASES[1], (0, 1), (cut[1], cut[2])))
    shares = [spans.device_share(run, name, tiled) for name in PHASES]
    assert sum(shares) == pytest.approx(busy, abs=1e-9)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_pb_span_readers_none_where_nothing_to_read(metric, monkeypatch):
    read = bench.load_module("metrics", metric).read
    name = READERS[metric]
    run = _run((0, 100), [(10, 60)])
    cases = {"no trace": (SimpleNamespace(timeline=None),
                          [_span(name, (0, 50), (0, 50))]),
             "no span of its name": (run, [_span("other", (0, 50),
                                                 (0, 50))]),
             "no device interval": (run, [_span(name, (0, 50))])}
    for why, (r, rec) in cases.items():
        monkeypatch.setattr(spans, "program_spans",
                            lambda run, rec=rec: rec)
        assert read(r) is None, why
    monkeypatch.setattr(spans, "program_spans",
                        lambda run: [_span(name, (0, 50), (0, 50))])
    assert read(run) == pytest.approx(40.0 if "share" in metric else 10.0)


def test_pb_device_intervals_come_from_the_traces_marks(monkeypatch):
    """The program's spans take their device intervals from the marks in
    the window's own trace: a span holds what ran between its two."""
    from repro_torch import spans as program
    rec = [program.Span(1, None, 1, "lm.forward", 0, 90, marks=(0, 3)),
           program.Span(2, 1, 1, "lm.head", 10, 80, marks=(1, 2))]
    monkeypatch.setattr(program, "recorded", lambda: rec)
    mark = "void spans::span_mark<{}>()".format
    run = SimpleNamespace(timeline=Timeline((0, 100), [
        (5, 6, mark(0)), (8, 10, mark(1)), (10, 30, "embed"),
        (30, 70, "gemm"), (70, 72, mark(2)), (80, 90, "norm"),
        (94, 95, mark(3))]))
    got = spans.program_spans(run)
    assert [s.device for s in got] == [(6, 94), (10, 70)]
    assert spans.device_share(run, "lm.head") == pytest.approx(60.0)
    # busy (8, 72) and (80, 90) inside (6, 94)
    assert spans.device_share(run, "lm.forward") == pytest.approx(74.0)


def test_pb_a_program_without_spans_gives_none(monkeypatch):
    """A program that records no span (the port before
    ``repro_torch.spans``) yields an empty list, and the readers None."""
    import repro_torch
    monkeypatch.delattr(repro_torch, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert spans.program_spans(_run((0, 100), [(10, 60)])) == []
    assert bench.load_module("metrics", "head_share.score").read(
        _run((0, 100), [(10, 60)])) is None
