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
slices' squares over the `model` group, so every rank clips alike.

Data parallelism: where the batch's logical axis maps to mesh axes of
more than one rank (``("pod", "data")`` by ``logical_to_pspec``), the
``batch`` given to ``train_step_fn`` is this rank's rows, as
``models.params.shard_params`` cuts them, and the step gives what the
reference's step on the whole batch gives (GSPMD's reduction, written
out): each slice's summed NLL is divided by the label count of the whole
batch (of the reference's microbatch that holds it), counts and losses
are summed over the batch's mesh axes, and so are the gradients (in bf16
under ``cfg.grad_compress``, "bf16 on the wire"), so every replica holds
the whole batch's gradient before AdamW.  ``launch.mesh.make_host_mesh``
builds a data axis of 1: there each rank's rows are the whole batch.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Tuple, Union

import torch

from ..models import axes_tree, forward, param_specs
from ..models.config import ModelConfig
from ..models.lm import nll_terms
from ..models.moe import moe_pspecs
from ..models.params import tree_leaves, tree_map
from ..parallel.sharding import MeshPolicy, logical_to_pspec, mesh_shape
from .optimizer import OptConfig, _paired, adamw_update

Device = Union[str, torch.device, None]


def _unflatten_like(tree: Any, leaves: list) -> Any:
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _mesh_gnorm(cfg: ModelConfig, mesh: Any, grads: Any):
    """The whole gradient's norm on ``mesh``, or None where no leaf is
    split over ranks (then each rank's own gradient is whole).  The
    gradients are alike on every replica of the batch's axes (reduced
    there), so only the `model` group's slices are summed."""
    if mesh is None:
        return None
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


def _batch_groups(policy: MeshPolicy, mesh: Any) -> Tuple[list, int, int]:
    """(process groups of the mesh axes the batch's rows are split over,
    the number of slices, this rank's slice): ``("pod", "data")`` by
    default, the first of them major."""
    if mesh is None:
        return [], 1, 0
    entry = logical_to_pspec(("batch",), policy, mesh)[0]
    names = () if entry is None else \
        (entry if isinstance(entry, tuple) else (entry,))
    sizes = mesh_shape(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    groups, n, i = [], 1, 0
    for name in names:
        n, i = n * sizes[name], i * sizes[name] + coord[name]
        if sizes[name] > 1:
            groups.append(mesh.get_group(name))
    return groups, n, i


def _sum_over(groups: list, *ts: torch.Tensor) -> None:
    import torch.distributed as dist
    for g in groups:
        for t in ts:
            dist.all_reduce(t, group=g)


def train_step_fn(params: Any, opt_state: Any, batch: Dict[str, Any], *,
                  cfg: ModelConfig, policy: MeshPolicy,
                  mesh: Any = None, opt: OptConfig = OptConfig(),
                  microbatches: int = 1, use_kernels: bool = False,
                  device: Device = None) -> Tuple[Any, Any, torch.Tensor]:
    """One optimizer step; ``params`` and ``opt_state`` are updated in
    place and returned with the loss.  With ``microbatches > 1`` the fp32
    gradients of the batch's slices are summed and, with the loss, divided
    by their count, as the reference's ``lax.scan`` accumulates them.  On
    a mesh that splits the batch, ``batch`` is this rank's rows and its
    microbatches are cut from them (module docstring)."""
    # leaves that require grad and share the parameters' storage
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    diff = _unflatten_like(params, leaves)
    groups, n_slices, me = _batch_groups(policy, mesh)
    m = max(1, microbatches)
    rows = batch["tokens"].shape[0] // m
    parts = [batch] if m == 1 else \
        [{k: v[j * rows:(j + 1) * rows] for k, v in batch.items()}
         for j in range(m)]
    # this rank's slice j is slice me*m + j of the whole batch, inside
    # the reference's microbatch (me*m + j) // n_slices; the label count
    # of each reference microbatch, summed over the batch's ranks
    where = [(me * m + j) // n_slices for j in range(m)]
    dev = leaves[0].device
    counts = torch.zeros(m, dtype=torch.float32, device=dev)
    for j, b in enumerate(parts):
        labels = torch.as_tensor(b["labels"]).to(dev)
        counts[where[j]] += (labels >= 0).sum().float()
    _sum_over(groups, counts)
    counts = counts.clamp_min(1.0)

    grads, loss = None, 0.0
    for j, b in enumerate(parts):
        total, _ = nll_terms(diff, b, cfg=cfg, policy=policy, mesh=mesh,
                             use_kernels=use_kernels, device=device)
        part = total / counts[where[j]]
        # a parameter the loss does not use (command-r's ln2) gets zeros,
        # as under jax.grad
        g = torch.autograd.grad(part, leaves, allow_unused=True,
                                materialize_grads=True)
        if m == 1:
            grads = list(g)
        elif grads is None:
            grads = [x.float() for x in g]
        else:
            for a, x in zip(grads, g):
                a.add_(x)
        loss = loss + part.detach()
    if m > 1:
        for g in grads:
            g.div_(m)
        loss = loss / m
    elif cfg.grad_compress:
        # bf16 on the wire (the DP/FSDP reduce-scatter happens on the
        # cast values); the optimizer re-ups to f32 for accumulation
        grads = [g.to(torch.bfloat16) for g in grads]
    _sum_over(groups, loss, *grads)
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
