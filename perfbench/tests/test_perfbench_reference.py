"""The plain reference against the program on the CPU at the
configurations' smoke sizes, both in fp32: the forwards' logits and the
first training steps' losses and norms.  The benchmark's weights are drawn once and handed to both."""
import statistics

import pytest
import torch

from perfbench.lib import inputs
from perfbench.reference import layout, models
from perfbench.reference.families import rwkv6
from perfbench.reference import train as ref_train
from perfbench_smoke import CPU, cell

FP32 = dict(dtype="float32")


def _rel(a, b):
    return float((a.float() - b).norm() / b.norm())


@pytest.mark.parametrize("name", ["rwkv6_3b.score-4k",
                                  "qwen1_5_4b.train-2k"])
def test_pb_forward_matches_program(name):
    from repro_torch.models import forward
    m = cell(name, **FP32).model
    cfg = inputs.program_config(m)
    params = layout.make_params(m, 3, CPU)
    inputs.check_layout(cfg, params)
    toks = inputs.tokens(3, "t", (2, 80), m["vocab_size"], CPU)
    with torch.no_grad():
        got, _ = forward(params, {"tokens": toks}, cfg=cfg, use_kernels=True,
                         device=CPU)
        want = models.forward(params, toks, m)
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-5


def test_pb_train_steps_match_program():
    from repro_torch.parallel.sharding import MeshPolicy
    from repro_torch.train import OptConfig, adamw_init, make_train_step
    c = cell("qwen1_5_4b.train-2k", **FP32)
    m, opt = c.model, c.traffic["opt"]
    cfg = inputs.program_config(m, remat="full")
    params = layout.make_params(m, 5, CPU)
    state = adamw_init(params)
    step = make_train_step(cfg, MeshPolicy(), opt=OptConfig(**opt),
                           use_kernels=True, device=CPU)
    batches = []
    for i in range(2):
        x = inputs.tokens(5, f"b{i}", (1, 41), m["vocab_size"], CPU)
        batches.append({"tokens": x[:, :-1], "labels": x[:, 1:]})
    losses = []
    for i, b in enumerate(batches):
        losses.append(float(step(params, state, b)[2]))
        if i == 0:
            grad1 = ref_train.slice_norms(state["mu"], 1 / (1 - opt["b1"]))
    change = ref_train.change_norms(params, m, 5)
    ref = ref_train.train_steps(m, 5, batches, opt, CPU)
    for a, b in zip(losses, ref["losses"]):
        assert abs(a - b) < 1e-5 * abs(b)
    med = statistics.median(ref["grad1"].values())
    assert set(grad1) == set(ref["grad1"]) == set(change)
    for n, r in ref["grad1"].items():
        assert abs(grad1[n] - r) < 1e-4 * max(r, med), n
    moved = [n for n, r in ref["grad1"].items() if r >= 1e-3 * med]
    medc = statistics.median(ref["change"][n] for n in moved)
    for n in moved:
        assert abs(change[n] - ref["change"][n]) < 1e-3 * max(
            ref["change"][n], medc), n


def test_pb_wkv_reference_is_the_recurrence():
    """The chunked WKV of the reference against the step-by-step
    recurrence in float64, across chunk boundaries."""
    g = torch.Generator().manual_seed(0)
    B, S, H, D = 2, 45, 3, 4
    r, k, v = (torch.randn(B, S, H, D, generator=g, dtype=torch.float64)
               for _ in range(3))
    w = torch.rand(B, S, H, D, generator=g, dtype=torch.float64) * 0.9 + 0.05
    u = torch.randn(H, D, generator=g, dtype=torch.float64)
    s = torch.zeros(B, H, D, D, dtype=torch.float64)
    ys = []
    for t in range(S):
        rt, kt, vt = r[:, t], k[:, t], v[:, t]
        ys.append(torch.einsum("bhi,bhij->bhj", rt, s)
                  + (rt * u * kt).sum(-1, keepdim=True) * vt)
        s = s * w[:, t, :, :, None] + kt[..., :, None] * vt[..., None, :]
    want = torch.stack(ys, 1)
    got = rwkv6.wkv(r, k, v, w, u, chunk=8, block=2)
    assert torch.allclose(got, want, rtol=1e-9, atol=1e-9)


def test_pb_float8_control_rounds_coarser():
    g = torch.Generator().manual_seed(1)
    a, b = torch.randn(64, 32, generator=g), torch.randn(32, 16, generator=g)
    exact = a.double() @ b.double()
    e32 = _rel(models.mm32(a, b).double(), exact)
    e8 = _rel(models.mm8(a, b).double(), exact)
    assert e32 < 1e-6 and 1e-2 < e8 < 0.2
