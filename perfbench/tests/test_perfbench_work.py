"""The yardstick's arithmetic against hand counts at small shapes: FLOPs
and bytes for MFU and each roofline, the busy union and idle gaps of a
timeline, and the readers' refusal to report a share of nothing."""
import math

import pytest

from perfbench.lib import bench, readers, work
from perfbench.lib.trace import Timeline

DENSE = {"family": "dense", "reference": "dense", "n_layers": 2, "d_model": 8, "n_heads": 2,
         "n_kv_heads": 1, "d_ff": 16, "vocab_size": 10, "dtype": "bfloat16"}
SSM = {"family": "ssm", "reference": "rwkv6", "n_layers": 1, "d_model": 4, "rwkv_head_dim": 4,
       "d_ff": 8, "decay_lora": 2, "vocab_size": 10, "n_heads": 1,
       "dtype": "bfloat16"}


@pytest.mark.parametrize("S,window,pairs", [(4, None, 10), (4, 2, 7),
                                            (1, None, 1), (5, 8, 15)])
def test_pb_causal_pairs(S, window, pairs):
    assert work.causal_pairs(S, window) == pairs


def test_pb_flash_work_by_hand():
    # B=1, S=4, H=2, KV=1, hd=4: 10 visible pairs a head, 4 hd each
    n_bytes, flops = work.flash_work(DENSE, 1, 4)
    assert flops == 4 * 4 * 2 * 10
    assert n_bytes == 2 * 4 * 4 * (2 * 2 + 2 * 1)


def test_pb_wkv_work_by_hand():
    # one chunk of L=3 steps, one head of D=4: 3 kept pairs
    n_bytes, flops = work.wkv_work(SSM, 1, 3)
    assert flops == (5 * 3 * 4 + 5 * 4 * 3 + 3 * 3 * 4 + 2 * 4 * (3 + 3)
                     + 5 * 3 * 4 + 4 * 3 * 16 + 3 * 16)
    assert n_bytes == 4 * 12 * 2 + 4 * (12 + 4) + 4 * 16


def test_pb_forward_flops_by_hand():
    # per token and layer: q 8x8, k and v 8x4 each, o 8x8, MLP 3 x 8x16
    proj = 2 * (64 + 2 * 32 + 64 + 3 * 128)
    attn = 4 * 4 * 2 * work.causal_pairs(3)
    head = 2 * 8 * 10 * 3
    assert work.forward_flops(DENSE, 1, 3) == 2 * (3 * proj + attn) + head
    assert work.train_flops(DENSE, 1, 3) == 3 * work.forward_flops(DENSE, 1, 3)
    r = 2 * (5 * 16 + 2 * 4 * 2 + 2 * 4 * 8 + 16)
    assert work.forward_flops(SSM, 1, 3) == 3 * r + work.wkv_work(
        SSM, 1, 3)[1] + 2 * 4 * 10 * 3


def test_pb_bound_takes_the_larger_side():
    t, by = work.bound_s(3.35e12, 1.0, "bfloat16")
    assert by == "bytes" and math.isclose(t, 1.0)
    t, by = work.bound_s(1.0, 989e12 * 2, "bfloat16")
    assert by == "operations" and math.isclose(t, 2.0)


def test_pb_timeline_union_and_gaps():
    tl = Timeline((0, 100_000_000),
                  device=[(0, 40_000_000, "a"), (10_000_000, 50_000_000, "b"),
                          (60_000_000, 70_000_000, "a"),
                          (95_000_000, 120_000_000, "c")],
                  host=[(40_000_000, 100_000_000, "sleep"),
                        (55_000_000, 58_000_000, "inner")])
    assert math.isclose(tl.busy_s(), 0.065)       # 50 + 10 + 5 ms, once
    assert list(tl.gaps()) == [(50_000_000, 60_000_000),
                               (70_000_000, 95_000_000)]
    assert tl.idle_by_host() == [["sleep", 0.035]]
    assert tl.kernel_s(lambda n: n == "a") == (0.05, 2)
    assert tl.top_ops(1) == [["a", 0.05]]


def _run(**kw):
    cell = bench.Cell("x", 1, {"model": DENSE}, {}, {}, [], [])
    return bench.Run(cell, 1, 1.0, True, None, **kw)


def test_pb_readers_report_nothing_without_work():
    run = _run()
    assert readers.idle_share(run) is None
    assert readers.mfu_window(run) is None
    assert readers.roofline(run, "flash_attention", readers.is_flash,
                            work.flash_work) is None


def test_pb_roofline_share_by_hand():
    calls = [{"B": 1, "S": 4, "t0": 0.0, "t1": 0.5, "flops": 1e12}] * 2
    tl = Timeline((0, 10**9), device=[(0, 1000, "flash_tc_kernel"),
                                      (2000, 3000, "gemm")])
    run = _run(calls=calls, counters={"launches": {"flash_attention": 4}},
               timeline=tl, window_s=1.0)
    least = 4 * work.bound_s(*work.flash_work(DENSE, 1, 4), "bfloat16")[0]
    assert math.isclose(readers.roofline(run, "flash_attention",
                                         readers.is_flash, work.flash_work),
                        100 * least / 1e-6)
    assert math.isclose(readers.mfu_window(run), 100 * 2e12 / 989e12)
    assert math.isclose(readers.idle_share(run), 100 * (1 - 2e-6))
