"""Training: the program's train step (loss, gradients with the layers
recomputed in the backward, AdamW in place) on rows drawn from the seed,
every step a new row.

Set-up builds one step with its parameters and AdamW state, and drives it
through its first ``checked_steps`` steps through the same call the
window makes; the window goes on with that same object.  The check runs
the reference over those first steps and compares each step's loss, each
leaf's norm of the first clipped gradient (worked out from the program's
first moment after one step: ``mu = (1 - b1) g``) and each leaf's norm of
the parameters' change after the last checked step.

``train_tokens_per_s`` is every token of the steps the window ran over
the window's time, to the end of the last step on the device.  Steps are
queued as a training loop queues them, without waiting for each (the
host enqueues the next step while the device finishes the last); the
``t0``/``t1`` of a call are the host's enqueue times.  Traffic keys: ``batch``, ``seq``, ``remat``,
``opt`` (AdamW's settings), ``checked_steps``, ``exclude_grad_below``
(leaves whose reference gradient is under this share of the median
leaf's are left out of the change: they move by rounding alone).
"""
from __future__ import annotations

import statistics
import time
from typing import Any, Dict, List

import torch

from perfbench.lib import inputs, work
from perfbench.reference import layout, models
from perfbench.reference import train as ref_train


def _batch(run, i: int) -> Dict[str, torch.Tensor]:
    t, m = run.cell.traffic, run.cell.model
    x = inputs.tokens(run.seed, f"train/{i}", (t["batch"], t["seq"] + 1),
                      m["vocab_size"], run.device)
    return {"tokens": x[:, :-1], "labels": x[:, 1:]}


def setup(run) -> Dict[str, Any]:
    from repro_torch.parallel.sharding import MeshPolicy
    from repro_torch.train import OptConfig, adamw_init, make_train_step
    m, t = run.cell.model, run.cell.traffic
    cfg = inputs.program_config(m, remat=t["remat"])
    params = layout.make_params(m, run.seed, run.device)
    inputs.check_layout(cfg, params)
    opt_state = adamw_init(params)
    step = make_train_step(cfg, MeshPolicy(), opt=OptConfig(**t["opt"]),
                           use_kernels=True, device=run.device)
    st: Dict[str, Any] = {"params": params, "opt": opt_state, "step": step,
                          "losses": []}
    for i in range(t["checked_steps"]):
        _, _, loss = step(params, opt_state, _batch(run, i))
        st["losses"].append(float(loss))
        if i == 0:
            st["grad1"] = ref_train.slice_norms(
                opt_state["mu"], 1 / (1 - t["opt"]["b1"]))
    with torch.no_grad():
        st["change"] = ref_train.change_norms(params, m, run.seed)
    return st


def window(run, st: Dict[str, Any]) -> None:
    t, m = run.cell.traffic, run.cell.model
    B, S = t["batch"], t["seq"]
    flops = work.train_flops(m, B, S)
    n, t0 = 0, time.perf_counter()
    while True:
        b = _batch(run, t["checked_steps"] + n)
        c0 = time.perf_counter()
        with run.span("train.step"):
            st["step"](st["params"], st["opt"], b)
        run.calls.append({"B": B, "S": S, "flops": flops, "t0": c0,
                          "t1": time.perf_counter()})
        n += 1
        if time.perf_counter() - t0 >= run.seconds:
            break
    inputs.sync(run.device)
    run.window_s = time.perf_counter() - t0
    run.attempted = n
    run.e2e["train_tokens_per_s"] = n * B * S / run.window_s


def release(run, st: Dict[str, Any]) -> None:
    st.pop("step", None)
    inputs.free(st.pop("opt"), st.pop("params"))


def reference(run, st: Dict[str, Any], mm=models.mm32) -> Dict[str, Any]:
    t = run.cell.traffic
    batches = [_batch(run, i) for i in range(t["checked_steps"])]
    with models.fp32_exact():
        return ref_train.train_steps(run.cell.model, run.seed, batches,
                                     t["opt"], run.device, mm=mm)


def outputs(run, st: Dict[str, Any]) -> Dict[str, Any]:
    return {k: st[k] for k in ("losses", "grad1", "change")}


def as_outputs(run, st: Dict[str, Any], ref: Dict[str, Any]
               ) -> Dict[str, Any]:
    return ref


def _worst(p: Dict[str, float], r: Dict[str, float], names: List[str]
           ) -> float:
    med = statistics.median(r[n] for n in names)
    return max(abs(p[n] - r[n]) / max(r[n], med) for n in names)


def judge(run, st, out: Dict[str, Any], ref: Dict[str, Any]
          ) -> Dict[str, float]:
    """Each step's loss against the reference's (relative), and by the
    worst leaf the gap between the program's and the reference's norms
    of the first gradient and of the change, over the larger of the
    leaf's reference norm and the median leaf's."""
    losses = max(abs(a - b) / abs(b) for a, b in zip(out["losses"],
                                                     ref["losses"]))
    names = sorted(ref["grad1"])
    med = statistics.median(ref["grad1"][n] for n in names)
    cut = run.cell.traffic["exclude_grad_below"] * med
    moved = [n for n in names if ref["grad1"][n] >= cut]
    return {"loss_rel_gap_max": losses,
            "grad1_norm_gap": _worst(out["grad1"], ref["grad1"], names),
            "change_norm_gap": _worst(out["change"], ref["change"], moved)}
