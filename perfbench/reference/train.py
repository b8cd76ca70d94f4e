"""The reference's first training steps: the model's mean next-token NLL
in fp32 (the forward of its family, ``families/``), its gradient by autograd (each layer recomputed
in the backward, so that the fp32 model fits beside its moments), the
clip by the global norm and AdamW, written from the formula: the same
steps the configuration states, nothing of the program's optimizer.

It returns what the check compares: each step's loss, each leaf's norm
of the first step's clipped gradient, and each leaf's norm of the change
of the parameters after the last step (the first parameters drawn again
from the seed, leaf by leaf).  A stacked leaf counts as one leaf a
layer.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterator, List, Tuple

import torch

from . import families, layout
from .models import MM, mm32


def named(path: Tuple[str, ...], t: torch.Tensor
          ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor) of one leaf, a stacked leaf once a layer."""
    if path[0] == "layers":
        for i in range(t.shape[0]):
            yield f"{'.'.join(path)}[{i}]", t[i]
    else:
        yield ".".join(path), t


def slices(tree: Dict[str, Any]) -> Iterator[Tuple[str, torch.Tensor]]:
    for path, t in _leaf_items(tree):
        yield from named(path, t)


def slice_norms(tree: Dict[str, Any], scale: float = 1.0) -> Dict[str, float]:
    return {n: float(t.float().norm()) * scale for n, t in slices(tree)}


def change_norms(tree: Dict[str, Any], model: Dict[str, Any], seed: int
                 ) -> Dict[str, float]:
    """Each leaf's norm of ``tree`` less the first parameters, those
    drawn again from ``seed`` one stacked leaf at a time."""
    out: Dict[str, float] = {}
    for leaf in layout.leaves(model):
        now = layout.get(tree, leaf.path)
        diff = now.detach() - layout.draw(leaf, seed, now.device)
        out.update((n, float(t.norm())) for n, t in named(leaf.path, diff))
        del diff
    return out


def nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean NLL over the labels >= 0, fp32."""
    lf = logits.float().reshape(-1, logits.shape[-1])
    lab = labels.reshape(-1).long()
    keep = lab >= 0
    logz = torch.logsumexp(lf, -1)
    gold = lf.gather(-1, lab.clamp_min(0)[:, None])[:, 0]
    return ((logz - gold) * keep).sum() / keep.sum().clamp_min(1)


def lr_at(opt: Dict[str, Any], step: int) -> float:
    """Warm-up, then cosine down to a tenth of ``lr``; ``step`` from 1."""
    warm = min(1.0, (step + 1) / max(1, opt["warmup_steps"]))
    t = min(1.0, max(0.0, (step - opt["warmup_steps"]) /
                     max(1, opt["total_steps"] - opt["warmup_steps"])))
    return opt["lr"] * warm * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * t)))


def train_steps(model: Dict[str, Any], seed: int, batches: List[Dict[str,
                torch.Tensor]], opt: Dict[str, Any], device: Any,
                mm: MM = mm32, loss_fn: Callable = nll) -> Dict[str, Any]:
    """``len(batches)`` AdamW steps of the fp32 model drawn from ``seed``:
    ``{"losses", "grad1", "change"}`` (``grad1``, ``change``: name ->
    norm)."""
    params = layout.make_params(model, seed, device)
    names = [n for n, _ in _leaf_items(params)]
    leaves = [t for _, t in _leaf_items(params)]
    for t in leaves:
        t.requires_grad_(True)
    mu = [torch.zeros_like(t) for t in leaves]
    nu = [torch.zeros_like(t) for t in leaves]
    losses, grad1 = [], {}
    b1, b2 = opt["b1"], opt["b2"]
    forward = families.load(model).forward
    for step, b in enumerate(batches, start=1):
        logits = forward(params, b["tokens"], model, mm=mm, remat=True)
        loss = loss_fn(logits, b["labels"])
        del logits
        grads = list(torch.autograd.grad(loss, leaves))
        losses.append(float(loss.detach()))
        del loss
        with torch.no_grad():
            gnorm = torch.sqrt(sum(g.square().sum() for g in grads))
            scale = float(torch.clamp(opt["grad_clip"] / (gnorm + 1e-9),
                                      max=1.0))
            if step == 1:
                grad1 = slice_norms(_tree(names, grads), scale)
            lr = lr_at(opt, step)
            b1c, b2c = 1 - b1 ** step, 1 - b2 ** step
            for i, (p, m_, v_) in enumerate(zip(leaves, mu, nu)):
                g, grads[i] = grads[i] * scale, None
                m_.mul_(b1).add_(g, alpha=1 - b1)
                v_.mul_(b2).addcmul_(g, g, value=1 - b2)
                delta = (m_ / b1c) / ((v_ / b2c).sqrt() + opt["eps"])
                p.sub_((delta + opt["weight_decay"] * p) * lr)
                del g, delta
    del mu, nu
    with torch.no_grad():
        change = change_norms(params, model, seed)
    return {"losses": losses, "grad1": grad1, "change": change}


def _leaf_items(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
                ) -> Iterator[Tuple[Tuple[str, ...], torch.Tensor]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_items(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _tree(names: List[Tuple[str, ...]], ts: Any) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, t in zip(names, ts):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return tree
