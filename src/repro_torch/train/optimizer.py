"""AdamW, the JAX package's ``repro.train.optimizer`` in PyTorch: the
same formula (global-norm clip; warmup, then cosine down to 10% of
``lr``; bias correction with fp32 powers of the step; decay as
``lr * (delta + wd * p)`` with ``p`` before the update; fp32 moments, the
parameter cast back to its dtype), not ``torch.optim.AdamW``.

The moments carry their parameters' logical axes (``opt_axes_tree``).
``adamw_update`` updates the caller's trees in place, leaf by leaf, and
returns them: a functional update would hold the old and the new
parameters and moments at once (47.4 GB more for qwen1.5-4B's
3,950,369,280 fp32 parameters).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from ..models.params import tree_leaves, tree_map


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def lr_at(c: OptConfig, step: Any) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a 0-d tensor), fp32."""
    s = torch.as_tensor(step).float()
    warm = torch.clamp((s + 1) / max(1, c.warmup_steps), max=1.0)
    t = torch.clamp((s - c.warmup_steps) /
                    max(1, c.total_steps - c.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return c.lr * warm * (0.1 + 0.9 * cos)


def adamw_init(params: Any) -> Dict[str, Any]:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    dev = tree_leaves(params)[0].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def adamw_abstract(params_abs: Any) -> Dict[str, Any]:
    """``adamw_init``'s shapes and dtypes on the ``meta`` device."""
    z = lambda p: torch.empty(p.shape, dtype=torch.float32,  # noqa: E731
                              device="meta")
    return {"mu": tree_map(z, params_abs), "nu": tree_map(z, params_abs),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def opt_axes_tree(param_axes: Any) -> Dict[str, Any]:
    """Moments shard exactly like their parameters."""
    return {"mu": param_axes, "nu": param_axes, "step": ()}


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum()
                          for x in tree_leaves(tree)))


def _paired(tree: Any, *others: Any) -> Iterator[Tuple[Any, ...]]:
    """The leaves of ``tree`` with the leaves at the same keys of
    ``others`` (whatever order their keys were inserted in)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paired(v, *(o[k] for o in others))
    else:
        yield (tree,) + others


@torch.no_grad()
def adamw_update(c: OptConfig, params: Any, grads: Any,
                 state: Dict[str, Any], gnorm: Optional[torch.Tensor] = None
                 ) -> Tuple[Any, Dict[str, Any]]:
    """One AdamW step.  Updates ``params``, ``state["mu"]``,
    ``state["nu"]`` and ``state["step"]`` in place and returns
    ``(params, state)``, the same objects.  ``gnorm`` is the norm of the
    whole gradient where ``grads`` holds only this rank's slices of some
    leaves (``train.step``); by default ``global_norm(grads)``."""
    step = state["step"]
    step.add_(1)
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(c.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_at(c, step)
    sf = step.float()
    b1c = 1 - torch.full_like(sf, c.b1).pow(sf)
    b2c = 1 - torch.full_like(sf, c.b2).pow(sf)
    for p, g, mu, nu in _paired(params, grads, state["mu"], state["nu"]):
        g = g.float() * scale
        mu.mul_(c.b1).add_(g, alpha=1 - c.b1)
        nu.mul_(c.b2).addcmul_(g, g, value=1 - c.b2)
        # g's buffer becomes the denominator, then a second one delta
        denom = torch.div(nu, b2c, out=g).sqrt_().add_(c.eps)
        delta = torch.div(mu, b1c).div_(denom)
        del g, denom
        pf = p.float()
        delta.add_(pf, alpha=c.weight_decay).mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(delta)
        else:
            p.copy_(pf.sub_(delta))
    return params, state
