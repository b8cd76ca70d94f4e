"""Scoring in a closed loop: one client sends batches of B sequences of S
tokens to the program's ``forward`` (logits at every position), the next
once the last is done, for the whole window.

``score_tokens_per_s`` is every token of the batches the window ran over
the window's time, the last batch's end included.  The check compares
the logits of sampled rows of one batch of the window (the batch and the
rows drawn from the seed) with the reference's, position by position.

Traffic keys: ``batch``, ``seq``, ``warm_calls`` (set-up calls on inputs
of their own), ``check_calls`` (the checked batch is one of the first
so many), ``check_rows``.
"""
from __future__ import annotations

import time
from typing import Any, Dict

import torch

from perfbench.lib import inputs, work
from perfbench.reference import layout, models


def _batch(run, i) -> torch.Tensor:
    t, m = run.cell.traffic, run.cell.model
    return inputs.tokens(run.seed, f"score/{i}", (t["batch"], t["seq"]),
                         m["vocab_size"], run.device)


def setup(run) -> Dict[str, Any]:
    from repro_torch.models import forward
    m, t = run.cell.model, run.cell.traffic
    cfg = inputs.program_config(m)
    params = layout.make_params(m, run.seed, run.device)
    inputs.check_layout(cfg, params)
    rng = inputs.host_rng(run.seed, "check")
    st = {"params": params,
          "call": lambda toks: forward(params, {"tokens": toks}, cfg=cfg,
                                       use_kernels=True, device=run.device),
          "check_call": rng.randrange(t["check_calls"]),
          "rows": inputs.pick(rng, t["batch"], t["check_rows"])}
    with torch.no_grad():
        for i in range(t["warm_calls"]):
            logits, _ = st["call"](_batch(run, f"warm{i}"))
            del logits
    return st


def window(run, st: Dict[str, Any]) -> None:
    t, m = run.cell.traffic, run.cell.model
    B, S = t["batch"], t["seq"]
    flops = work.forward_flops(m, B, S)
    n, t0 = 0, time.perf_counter()
    with torch.no_grad():
        while True:
            toks = _batch(run, n)
            c0 = time.perf_counter()
            with run.span("score.call"):
                logits, _ = st["call"](toks)
                if n == st["check_call"]:
                    st["kept"] = logits[st["rows"]].float().clone()
                del logits
                inputs.sync(run.device)
            run.calls.append({"B": B, "S": S, "flops": flops,
                              "t0": c0, "t1": time.perf_counter()})
            n += 1
            if time.perf_counter() - t0 >= run.seconds and \
                    n > st["check_call"]:
                break
    run.window_s = time.perf_counter() - t0
    run.attempted = n
    run.e2e["score_tokens_per_s"] = n * B * S / run.window_s


def release(run, st: Dict[str, Any]) -> None:
    st.pop("call", None)
    inputs.free(st.pop("params"))


def reference(run, st: Dict[str, Any], mm=models.mm32) -> Dict[str, Any]:
    """The reference's logits of the checked rows, its weights drawn
    again from the seed."""
    m = run.cell.model
    toks = _batch(run, st["check_call"])[st["rows"]]
    params = layout.make_params(m, run.seed, run.device)
    with torch.no_grad(), models.fp32_exact():
        logits = models.forward(params, toks, m, mm=mm)
    del params
    return {"logits": logits}


def outputs(run, st: Dict[str, Any]) -> Dict[str, Any]:
    return {"logits": st["kept"]}


def as_outputs(run, st: Dict[str, Any], ref: Dict[str, Any]
               ) -> Dict[str, Any]:
    return ref


def judge(run, st, out: Dict[str, Any], ref: Dict[str, Any]
          ) -> Dict[str, float]:
    """The widest relative L2 distance of a position's logits."""
    p, r = out["logits"], ref["logits"]
    err = (p - r).norm(dim=-1) / r.norm(dim=-1).clamp_min(1e-30)
    return {"logits_rel_err_max": float(err.max())}
