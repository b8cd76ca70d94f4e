"""Train / serve step builders, the JAX package's ``repro.train.step`` in
PyTorch (its launcher jit-compiles them; here they run eagerly).

``train_step_fn``   — loss + gradients (``torch.autograd.grad`` over the
                      parameter leaves) + the in-place AdamW update, with
                      optional gradient accumulation over microbatches.
``prefill_step_fn`` — forward over a full prompt, filling the KV cache.
``decode_step_fn``  — one token against the cache.

The serving steps consume the cache they are given, as the reference's
launcher donates it (``donate_argnums=(2,)``): each layer's new rows and
states are written into it (``forward(..., donate_cache=True)``) and the
step returns that same storage.  A caller that needs the old cache
afterwards clones it first.

``use_kernels`` is the reference's ``use_pallas``; ``device`` is where the
parameters are (the card unless ``device="cpu"``), as ``forward`` takes
it.  On a mesh each rank runs the step on its shards of the parameters
and of AdamW's moments, as ``parallel.sharding.storage_pspecs`` stores
them (heads, MLP, vocabulary and experts over `model`; under FSDP the
`embed` dimension over `data`), and AdamW updates those shards; the
gradient's norm for the clip sums each leaf's squared shard over the
groups that split it (a leaf split over none counted once), so every rank
clips alike.

Data parallelism: where the batch's logical axis maps to mesh axes of
more than one rank (``("pod", "data")`` by ``logical_to_pspec``), the
``batch`` given to ``train_step_fn`` is this rank's rows, as
``models.params.shard_params`` cuts them, and the step gives what the
reference's step on the whole batch gives (GSPMD's reduction, written
out): each slice's summed NLL is divided by the label count of the whole
batch (of the reference's microbatch that holds it), counts and losses
are summed over the batch's mesh axes, and so are the gradients (in bf16
under ``cfg.grad_compress``, "bf16 on the wire"), so every replica holds
the whole batch's gradient of its shards before AdamW.  A leaf that FSDP
splits over `data` had its gradient reduce-scattered over `data` in the
backward (``parallel.sharding.gather_leaf``): it is summed over the
batch's other axes only, so no gradient is summed twice.  ``launch.mesh.make_host_mesh``
builds a data axis of 1: there each rank's rows are the whole batch.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Tuple, Union

import torch

from ..models import forward, param_specs
from ..models.config import ModelConfig
from ..models.lm import nll_terms
from ..models.params import tree_leaves, tree_map
from ..parallel.sharding import (MeshPolicy, _names, grad_wire,
                                 logical_to_pspec, mesh_shape,
                                 storage_pspecs)
from ..spans import span
from .optimizer import OptConfig, _paired, adamw_update

Device = Union[str, torch.device, None]


def _unflatten_like(tree: Any, leaves: list) -> Any:
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _split_axes(spec: Any, sizes: Dict[str, int]) -> Tuple[str, ...]:
    """The mesh axes of more than one rank that split a leaf."""
    return tuple(sorted({a for e in spec for a in _names(e)
                         if sizes[a] > 1}))


def _mesh_gnorm(cfg: ModelConfig, policy: MeshPolicy, mesh: Any,
                grads: Any):
    """The whole gradient's norm on ``mesh``, or None where no leaf is
    split over ranks (then each rank's own gradient is whole).  The
    gradients are alike on every rank of the axes that do not split them
    (reduced there), so each leaf's squared shard is summed over the
    groups of the axes that do, leaves grouped by those axes, one
    all-reduce a group of axes."""
    if mesh is None:
        return None
    sizes = mesh_shape(mesh)
    specs = storage_pspecs(param_specs(cfg), policy, mesh)
    parts: Dict[Tuple[str, ...], list] = {}
    for g, spec in _paired(grads, specs):
        parts.setdefault(_split_axes(spec, sizes), []).append(
            g.float().square().sum())
    if set(parts) <= {()}:
        return None
    import torch.distributed as dist
    total = None
    for axes, sq in parts.items():
        part = torch.stack(sq).sum()
        for name in axes:
            dist.all_reduce(part, group=mesh.get_group(name))
        total = part if total is None else total + part
    return torch.sqrt(total)


def _batch_axes(policy: MeshPolicy, mesh: Any) -> Tuple[list, int, int]:
    """(the mesh axes of more than one rank the batch's rows are split
    over, the number of slices, this rank's slice): ``("pod", "data")``
    by default, the first of them major."""
    if mesh is None:
        return [], 1, 0
    entry = logical_to_pspec(("batch",), policy, mesh)[0]
    sizes = mesh_shape(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    names, n, i = [], 1, 0
    for name in _names(entry):
        n, i = n * sizes[name], i * sizes[name] + coord[name]
        if sizes[name] > 1:
            names.append(name)
    return names, n, i


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
    with span("train.step", params["embed"]["tok"]):
        return _train_step(params, opt_state, batch, cfg=cfg, policy=policy,
                           mesh=mesh, opt=opt, microbatches=microbatches,
                           use_kernels=use_kernels, device=device)


def _train_step(params, opt_state, batch, *, cfg, policy, mesh, opt,
                microbatches, use_kernels, device):
    # leaves that require grad and share the parameters' storage
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    diff = _unflatten_like(params, leaves)
    axes, n_slices, me = _batch_axes(policy, mesh)
    groups = [mesh.get_group(a) for a in axes]
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
    # FSDP's reduce-scatters in bf16 where the gradients go out in bf16
    wire = torch.bfloat16 if cfg.grad_compress and m == 1 else None
    for j, b in enumerate(parts):
        with grad_wire(wire):
            with span("train.forward", dev):
                total, _ = nll_terms(diff, b, cfg=cfg, policy=policy,
                                     mesh=mesh, use_kernels=use_kernels,
                                     device=device)
                part = total / counts[where[j]]
            # a parameter the loss does not use (command-r's ln2) gets
            # zeros, as under jax.grad
            with span("train.backward", dev):
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
    _sum_over(groups, loss)
    grads = _unflatten_like(params, grads)
    if groups:
        # a leaf split over a batch axis was summed there in the backward
        sizes = mesh_shape(mesh)
        specs = storage_pspecs(param_specs(cfg), policy, mesh)
        for g, spec in _paired(grads, specs):
            done = _split_axes(spec, sizes)
            _sum_over([mesh.get_group(a) for a in axes if a not in done], g)
    with span("train.optimizer", dev):
        adamw_update(opt, params, grads, opt_state,
                     gnorm=_mesh_gnorm(cfg, policy, mesh, grads))
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
                                use_kernels=use_kernels, device=device,
                                donate_cache=True)
    return logits[:, -1:], new_cache


def decode_step_fn(params: Any, batch: Dict[str, Any], cache: Any,
                   index: Any, *, cfg: ModelConfig, policy: MeshPolicy,
                   mesh: Any = None, use_kernels: bool = False,
                   device: Device = None) -> Tuple[torch.Tensor, Any]:
    """`serve_step`: one new token (batch["tokens"] is [B,1]) against a KV
    cache of seq_len, written in place (the cache is donated)."""
    logits, new_cache = forward(params, batch, cfg=cfg, policy=policy,
                                mesh=mesh, cache=cache, cache_index=index,
                                use_kernels=use_kernels, device=device,
                                donate_cache=True)
    return logits, new_cache


def make_decode_step(cfg: ModelConfig, policy: MeshPolicy, mesh: Any = None,
                     use_kernels: bool = False, device: Device = None):
    return functools.partial(decode_step_fn, cfg=cfg, policy=policy,
                             mesh=mesh, use_kernels=use_kernels,
                             device=device)
