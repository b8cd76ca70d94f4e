"""Train / serve step builders, the JAX package's ``repro.train.step`` in
PyTorch (its launcher jit-compiles them; here they run eagerly).

``train_step_fn``   — loss + gradients (``torch.autograd.grad`` over the
                      parameter leaves) + the in-place AdamW update, with
                      optional gradient accumulation over microbatches.
``prefill_step_fn`` — forward over a full prompt, filling the KV cache.
``decode_step_fn``  — one token against the cache.

``use_kernels`` is the reference's ``use_pallas``; ``device`` is where the
parameters are (the card unless ``device="cpu"``), as ``forward`` takes
it.  On a mesh each rank runs the step on its own copy of the batch and of
the replicated parameters, and on its slices of the experts
(``models.moe.moe_pspecs``); the gradient's norm for the clip sums those
slices' squares over the `model` group, so every rank clips alike.  The
data axis must be 1, as ``launch.mesh.make_host_mesh`` builds it: the
batch is not split over ranks.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Tuple, Union

import torch

from ..models import axes_tree, forward, loss_fn, param_specs
from ..models.config import ModelConfig
from ..models.moe import moe_pspecs
from ..models.params import tree_leaves, tree_map
from ..parallel.sharding import MeshPolicy, mesh_shape
from .optimizer import OptConfig, _paired, adamw_update

Device = Union[str, torch.device, None]


def _unflatten_like(tree: Any, leaves: list) -> Any:
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _mesh_gnorm(cfg: ModelConfig, mesh: Any, grads: Any):
    """The whole gradient's norm on ``mesh``, or None where no leaf is
    split over ranks (then each rank's own gradient is whole)."""
    if mesh is None:
        return None
    sizes = mesh_shape(mesh)
    if sizes.get("data", 1) * sizes.get("pod", 1) != 1:
        raise ValueError(f"train step on a {sizes} mesh: the data axis "
                         f"must be 1 (each rank runs the whole batch)")
    specs = moe_pspecs(axes_tree(param_specs(cfg)), cfg, mesh)
    whole, split = [], []
    for g, spec in _paired(grads, specs):
        (split if any(e is not None for e in spec) else whole).append(
            g.float().square().sum())
    if not split:
        return None
    import torch.distributed as dist
    part = torch.stack(split).sum()
    dist.all_reduce(part, group=mesh.get_group("model"))
    return torch.sqrt(torch.stack(whole).sum() + part)


def train_step_fn(params: Any, opt_state: Any, batch: Dict[str, Any], *,
                  cfg: ModelConfig, policy: MeshPolicy,
                  mesh: Any = None, opt: OptConfig = OptConfig(),
                  microbatches: int = 1, use_kernels: bool = False,
                  device: Device = None) -> Tuple[Any, Any, torch.Tensor]:
    """One optimizer step; ``params`` and ``opt_state`` are updated in
    place and returned with the loss.  With ``microbatches > 1`` the fp32
    gradients of the batch's slices are summed and, with the loss, divided
    by their count, as the reference's ``lax.scan`` accumulates them."""
    # leaves that require grad and share the parameters' storage
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    diff = _unflatten_like(params, leaves)

    def value_and_grad(b):
        loss = loss_fn(diff, b, cfg=cfg, policy=policy, mesh=mesh,
                       use_kernels=use_kernels, device=device)
        # a parameter the loss does not use (command-r's ln2) gets zeros,
        # as under jax.grad
        return loss.detach(), torch.autograd.grad(
            loss, leaves, allow_unused=True, materialize_grads=True)

    if microbatches <= 1:
        loss, grads = value_and_grad(batch)
        if cfg.grad_compress:
            # bf16 on the wire (the DP/FSDP reduce-scatter happens on the
            # cast values); the optimizer re-ups to f32 for accumulation
            grads = [g.to(torch.bfloat16) for g in grads]
    else:
        mb = batch["tokens"].shape[0] // microbatches
        grads, loss = None, 0.0
        for i in range(microbatches):
            part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            l, g = value_and_grad(part)
            if grads is None:
                grads = [x.float() for x in g]
            else:
                for a, x in zip(grads, g):
                    a.add_(x)
            loss = loss + l
        for g in grads:
            g.div_(microbatches)
        loss = loss / microbatches
    grads = _unflatten_like(params, grads)
    adamw_update(opt, params, grads, opt_state,
                 gnorm=_mesh_gnorm(cfg, mesh, grads))
    return params, opt_state, loss


def make_train_step(cfg: ModelConfig, policy: MeshPolicy, mesh: Any = None,
                    opt: OptConfig = OptConfig(), microbatches: int = 1,
                    use_kernels: bool = False, device: Device = None):
    return functools.partial(train_step_fn, cfg=cfg, policy=policy,
                             mesh=mesh, opt=opt, microbatches=microbatches,
                             use_kernels=use_kernels, device=device)


def prefill_step_fn(params: Any, batch: Dict[str, Any], cache: Any, *,
                    cfg: ModelConfig, policy: MeshPolicy, mesh: Any = None,
                    use_kernels: bool = False, device: Device = None
                    ) -> Tuple[torch.Tensor, Any]:
    logits, new_cache = forward(params, batch, cfg=cfg, policy=policy,
                                mesh=mesh, cache=cache, cache_index=None,
                                use_kernels=use_kernels, device=device)
    return logits[:, -1:], new_cache


def decode_step_fn(params: Any, batch: Dict[str, Any], cache: Any,
                   index: Any, *, cfg: ModelConfig, policy: MeshPolicy,
                   mesh: Any = None, use_kernels: bool = False,
                   device: Device = None) -> Tuple[torch.Tensor, Any]:
    """`serve_step`: one new token (batch["tokens"] is [B,1]) against a KV
    cache of seq_len."""
    logits, new_cache = forward(params, batch, cfg=cfg, policy=policy,
                                mesh=mesh, cache=cache, cache_index=index,
                                use_kernels=use_kernels, device=device)
    return logits, new_cache


def make_decode_step(cfg: ModelConfig, policy: MeshPolicy, mesh: Any = None,
                     use_kernels: bool = False, device: Device = None):
    return functools.partial(decode_step_fn, cfg=cfg, policy=policy,
                             mesh=mesh, use_kernels=use_kernels,
                             device=device)
