"""The program's spans (``repro_torch.spans``): nothing recorded and no
mark launched without a profiler; under one, a train step's phases
nested as the program runs them, the LM head reached by every family,
the numbers bitwise those of a run without the profiler, each session's
record its own, and the marks in a trace paired with the spans that
launched them.

    PYTHONPATH=src python -m pytest -q tests/test_torch_spans.py

The card test runs both benchmark cells' calls under the device-only
trace the benchmark takes and holds the spans' device intervals to it:

    PYTHONPATH=src python -m pytest -q -s --noconftest -m cuda \\
        tests/test_torch_spans.py
"""
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.models import forward, init_params, param_specs
from repro_torch.models.params import tree_leaves
from repro_torch.parallel.sharding import MeshPolicy
from repro_torch.train import OptConfig, adamw_init, make_train_step

CPU = "cpu"
STEP = ["train.step", "train.forward", "lm.forward", "lm.head",
        "train.backward", "train.optimizer"]


def _model(arch="qwen1_5_4b"):
    cfg = get_smoke_config(arch)
    params = init_params(param_specs(cfg), torch.Generator().manual_seed(0),
                         device=CPU)
    return cfg, params


def _batch(cfg, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + 1)))
    b = {"tokens": x[:, :-1], "labels": x[:, 1:]}
    if cfg.family == "vlm":
        b["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32))
        b["positions"] = torch.arange(S)[None, :, None].expand(B, S, 3)
    if cfg.family == "encdec":
        b["frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32))
    return b


def _step(cfg):
    return make_train_step(cfg, MeshPolicy(), opt=OptConfig(), device=CPU)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, spans.recorded()


def test_off_records_nothing_and_makes_no_event(monkeypatch):
    cfg, params = _model()
    before = spans.recorded()

    def refused(*a, **k):
        raise AssertionError("read or made while no profiler runs")

    monkeypatch.setattr(torch.cuda, "Event", refused)
    monkeypatch.setattr(spans, "_launch_mark", refused)
    monkeypatch.setattr(spans, "time", SimpleNamespace(time_ns=refused))
    assert spans.span("a", torch.device("cuda")) is spans.span("b")
    b = _batch(cfg)
    forward(params, b, cfg=cfg, device=CPU)
    _step(cfg)(params, adamw_init(params), b)
    assert spans.recorded() == before


def test_a_train_step_records_its_phases_nested():
    cfg, params = _model()
    _, rec = _profiled(lambda: _step(cfg)(params, adamw_init(params),
                                          _batch(cfg)))
    assert [s.name for s in rec] == STEP
    step, fwd, lm, head, bwd, opt = rec
    assert step.parent is None
    assert [s.parent for s in rec[1:]] == [step.id, fwd.id, lm.id, step.id,
                                           step.id]
    assert {s.root for s in rec} == {step.id}
    assert len({s.id for s in rec}) == len(rec)
    for s in rec:
        assert s.start_ns <= s.end_ns and s.device is None
    for outer, inner in ((step, fwd), (fwd, lm), (lm, head), (step, bwd),
                         (step, opt)):
        assert outer.start_ns <= inner.start_ns <= inner.end_ns <= \
            outer.end_ns
    assert fwd.end_ns <= bwd.start_ns <= bwd.end_ns <= opt.start_ns


@pytest.mark.parametrize("arch", ARCHS)
def test_every_family_reaches_the_head_span(arch):
    cfg, params = _model(arch)
    (logits, _), rec = _profiled(lambda: forward(params, _batch(cfg),
                                                 cfg=cfg, device=CPU))
    assert torch.isfinite(logits).all()
    assert [s.name for s in rec] == ["lm.forward", "lm.head"]
    lm, head = rec
    assert (lm.parent, head.parent, head.root) == (None, lm.id, lm.id)


def test_the_profiler_changes_no_number():
    cfg, _ = _model()
    b = _batch(cfg)
    out = []
    for on in (False, True):
        _, params = _model()
        opt = adamw_init(params)
        run = lambda: [_step(cfg)(params, opt, b)[2] for _ in range(2)]
        losses = _profiled(run)[0] if on else run()
        out.append((losses, tree_leaves(params)))
    (l0, p0), (l1, p1) = out
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


def test_a_second_session_starts_from_an_empty_record():
    cfg, params = _model()
    b = _batch(cfg)
    _, first = _profiled(lambda: _step(cfg)(params, adamw_init(params), b))
    assert [s.name for s in first] == STEP
    forward(params, b, cfg=cfg, device=CPU)          # no profiler: nothing
    _, second = _profiled(lambda: forward(params, b, cfg=cfg, device=CPU))
    assert [s.name for s in second] == ["lm.forward", "lm.head"]
    assert min(s.id for s in second) > max(s.id for s in first)
    assert spans.recorded() == second


def test_two_sessions_unread_leave_the_second_in_the_record():
    """Two sessions one after the other, nothing reading the record
    between them: it holds the second session's spans alone."""
    cfg, params = _model()
    b = _batch(cfg)
    with profile(activities=[ProfilerActivity.CPU]):
        _step(cfg)(params, adamw_init(params), b)
    with profile(activities=[ProfilerActivity.CPU]):
        forward(params, b, cfg=cfg, device=CPU)
    rec = spans.recorded()
    assert [s.name for s in rec] == ["lm.forward", "lm.head"]
    assert rec[1].parent == rec[0].id


class _FakeCard:
    """The marks a span launches, each run on a fake card for 2 ns at the
    clock's time, the clock moved on by 10 ns a launch."""

    def __init__(self):
        self.t, self.ran = 0, []

    def launch(self, k):
        self.t += 10
        self.ran.append((self.t, self.t + 2,
                         f"void spans::span_mark<{k}>()"))


def test_marks_pair_with_the_sessions_trace(monkeypatch):
    """Each session numbers its marks from 0; a span's device interval
    runs from its first mark's end to its second's start in the trace;
    the marks' classes number them where the trace lost some at either
    end or stamped some out of their order."""
    card = _FakeCard()
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled",
                        False)
    monkeypatch.setattr(spans, "_launch_mark", card.launch)
    where = torch.device("cuda", 0)
    torch.autograd.profiler._run_on_profiler_start()     # a session
    with spans.span("before", where):
        pass
    torch.autograd.profiler._run_on_profiler_start()     # the next one
    card.ran = []
    with spans.span("outer", where):
        with spans.span("inner", where):
            pass
        with spans.span("host", torch.zeros(1)):
            pass
    with spans.span("last", where):
        pass
    rec = spans.recorded()
    assert [s.name for s in rec] == ["outer", "inner", "host", "last"]
    assert [s.marks for s in rec] == [(0, 3), (1, 2), None, (4, 5)]
    assert [int(spans.MARK.search(n).group(1)) for *_, n in card.ran] == \
        list(range(6))
    kernels = [(0, 100, "gemm"), (13, 19, "flash")]
    got = spans.on_card(rec, card.ran + kernels)
    assert [s.device for s in got] == [(32, 60), (42, 50), None, (72, 80)]
    assert all(s.device is None for s in rec)            # a new list
    lost = spans.on_card(rec, card.ran[2:-1] + kernels)  # both ends lost
    assert [s.device for s in lost] == [None, None, None, None]
    lost = spans.on_card(rec, card.ran[1:] + kernels)
    assert [s.device for s in lost] == [None, (42, 50), None, (72, 80)]
    # the inner span's marks stamped in the reverse order: no interval
    swapped = list(card.ran)
    swapped[1], swapped[2] = ((swapped[2][0], swapped[2][1], card.ran[1][2]),
                              (swapped[1][0], swapped[1][1], card.ran[2][2]))
    got = spans.on_card(rec, swapped)
    assert [s.device for s in got] == [(32, 60), None, None, (72, 80)]
    # a second copy of the marks numbers past the launched: unread
    assert spans.on_card(rec, card.ran * 2) == spans.on_card(rec, card.ran)


def test_mark_classes_match_their_kernels():
    """:data:`spans.MARKS` is the kernels' own count of classes."""
    import re
    from repro_torch.kernels import _build
    src = (_build.CSRC / "span_marks.cu").read_text()
    assert "span_marks.cu" in _build.SOURCES
    assert int(re.search(r"#define SPAN_MARKS (\d+)", src).group(1)) == \
        spans.MARKS
    table = src[src.index("kMarks[SPAN_MARKS])() = {"):]
    table = table[:table.index("};")]
    assert [int(k) for k in re.findall(r"span_mark<(\d+)>", table)] == \
        list(range(spans.MARKS))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

SEED = 3141592653


def _inside(intervals, marks):
    """Device ns of ``intervals`` inside ``marks``, which must not
    overlap (spans one after another on one stream)."""
    m = sorted(marks)
    assert all(b <= c for (_, b), (c, _) in zip(m, m[1:]))
    return sum(max(0, min(e, b) - max(s, a))
               for s, e in intervals for a, b in m)


def _cell(name, seconds):
    """A cell's traced window, then its check, as the benchmark runs them
    (the spans are read after the check, as its readers read them), and
    the spans with their device intervals from the window's trace."""
    from perfbench.lib import bench, harness
    from repro_torch import kernels
    cell = bench.load_cell(name)
    run, driver, st, _ = harness.measure(
        cell, SEED, seconds, True, torch.device("cuda", 0),
        time.perf_counter(), kernels)
    driver.release(run, st)
    correct, checks = harness.check(run, driver, st)
    del st
    torch.cuda.empty_cache()
    assert correct, checks
    rec = spans.recorded()
    seen = sum(bool(spans.MARK.search(n)) for *_, n in run.timeline.device)
    print(f"\n{name}: {seen} of {2 * sum(bool(s.marks) for s in rec)} "
          f"marks in the trace")
    return run, spans.on_card(rec, run.timeline.device)


def _margins(kernels, mark):
    """(first start - the mark's start, its end - last end) of the
    ``kernels`` that begin inside ``mark``."""
    a, b = mark
    inner = [(s, e) for s, e in kernels if a <= s <= b]
    if not inner:
        return None
    return min(s for s, _ in inner) - a, b - max(e for _, e in inner)


def _lag_ms(rec):
    """The least and the largest time (ms) from a span's start on the
    host to its device interval's start in the trace: a kernel starts
    after its launch, so a negative least says the trace's clock runs
    behind the host's epoch clock by at least that."""
    lags = [(s.device[0] - s.start_ns) / 1e6 for s in rec if s.device]
    return round(min(lags), 3), round(max(lags), 3)


def _fp32_gemm(name):
    return "gemm" in name and ("f32f32" in name or "sgemm" in name)


def _within(kernels, roots):
    """The ``kernels`` that start inside one of the ``roots``' device
    intervals: the calls or steps whose marks the trace holds (it may
    lose a session's first or last records)."""
    return [(s, e) for s, e in kernels if _inside([(s, s + 1)], roots)]


@pytest.mark.cuda
def test_spans_hold_the_card_work_of_both_cells():
    """Scoring: at least 99% of the fp32 head GEMM's device time inside
    ``lm.head``'s device intervals.  Training: every flash launch inside
    ``train.forward`` or ``train.backward``, one ``train.step`` a step.
    Both of the calls or steps whose intervals the trace holds, all but
    the first and the last at most."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the spans' marks run on the card")
    from perfbench.lib import readers

    run, rec = _cell("rwkv6_3b.score-4k", 4.0)
    calls = [s.device for s in rec if s.name == "lm.forward" and s.device]
    heads = [s.device for s in rec if s.name == "lm.head" and s.device]
    gemm = _within([(s, e) for s, e, n in run.timeline.device
                    if _fp32_gemm(n)], calls)
    total = sum(e - s for s, e in gemm)
    share = _inside(gemm, heads) / total
    print(f"scoring: {run.attempted} calls, {len(calls)} held, "
          f"{len(gemm)} fp32 GEMMs in them, {total / 1e9:.6f} s, inside "
          f"lm.head {100 * share:.4f}%; the GEMM's margins in its span, "
          f"first and last call (ns): {_margins(gemm, heads[0])}, "
          f"{_margins(gemm, heads[-1])}; host start to trace start (ms, "
          f"least and largest): {_lag_ms(rec)}")
    assert len(calls) >= run.attempted - 2 and share >= 0.99

    run, rec = _cell("qwen1_5_4b.train-2k", 4.0)
    steps = [s.device for s in rec if s.name == "train.step" and s.device]
    marks = [s.device for s in rec
             if s.name in ("train.forward", "train.backward") and s.device]
    flash = _within([(s, e) for s, e, n in run.timeline.device
                     if readers.is_flash(n)], steps)
    outside = [f for f in flash if _inside([f], marks) < f[1] - f[0]]
    print(f"training: {run.attempted} steps, "
          f"{sum(s.name == 'train.step' for s in rec)} train.step spans, "
          f"{len(steps)} held, {len(flash)} flash launches in them, "
          f"{len(outside)} outside; the flash launches' margins in the "
          f"first and the last step's forward and backward (ns): "
          f"{[_margins(flash, m) for m in marks[:2] + marks[-2:]]}; host "
          f"start to trace start (ms, least and largest): {_lag_ms(rec)}")
    for name in ("train.step", "train.forward", "train.backward",
                 "train.optimizer"):
        got = [s for s in rec if s.name == name and s.device]
        host = sum(s.end_ns - s.start_ns for s in got) / len(got) / 1e6
        card = sum(b - a for a, b in (s.device for s in got)) / len(got) / 1e6
        print(f"{name}: host {host:.3f} ms, card interval {card:.3f} ms")
    assert len(steps) >= run.attempted - 2 and flash and not outside
    assert sum(s.name == "train.step" for s in rec) == run.attempted
