"""GPipe-style pipeline parallelism over a `stage` axis of a device mesh,
the JAX package's ``repro.parallel.pipeline``.

Microbatch activations rotate through the stages; each stage applies its
local layer block.  The reference's ``ppermute`` is a ring of
``batch_isend_irecv`` over the axis's process group, and its final
``psum`` of the last stage's outputs an ``all_reduce``.  The collectives
are the plain ones: the pipeline computes the forward (the reference's
tests and deployments use it so), and the last stage's outputs reach
every rank.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from ..models.params import tree_leaves, tree_map
from .sharding import mesh_shape


def pipeline_apply(layer_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stacked_params: Any, x: torch.Tensor, *, mesh: Any,
                   stage_axis: str = "stage",
                   n_microbatches: int = None) -> torch.Tensor:
    """Run `x` through `n_stages * layers_per_stage` layers, stages sharded
    over `stage_axis`.

    stacked_params: this rank's block of the reference's stacked tree,
      leading ``[1, layers_per_stage, ...]`` (``models.shard_params`` with
      ``PartitionSpec(stage_axis)`` on the full ``[n_stages, ...]`` tree).
    x: [n_microbatches, mb, ...] microbatched activations, alike on every
      rank.

    Schedule (GPipe): T = n_micro + n_stages - 1 ticks; at tick t, stage s
    processes microbatch (t - s) if 0 <= t - s < n_micro (a stage outside
    that range passes its input on, as the reference's masked compute
    does, without computing).  Activations hop stage -> stage+1 each
    tick; the bubble is the (S-1)/(M+S-1) of :func:`pipeline_bubble_fraction`.
    """
    S = mesh_shape(mesh)[stage_axis]
    M = x.shape[0] if n_microbatches is None else n_microbatches
    group = mesh.get_group(stage_axis)
    sid = mesh.get_local_rank(stage_axis)
    params_me = tree_map(lambda a: a[0], stacked_params)
    n_layers = tree_leaves(params_me)[0].shape[0]
    layers = [tree_map(lambda a, i=i: a[i], params_me)
              for i in range(n_layers)]
    if S > 1:
        nxt = dist.get_global_rank(group, (sid + 1) % S)
        prev = dist.get_global_rank(group, (sid - 1) % S)

    buf = torch.zeros_like(x[0])          # activation entering this stage
    outs = torch.zeros_like(x)
    for t in range(M + S - 1):
        mb = t - sid                      # microbatch at this stage
        # stage 0 ingests a fresh microbatch from x
        h = x[min(t, M - 1)] if sid == 0 else buf
        if 0 <= mb < M:
            for lp in layers:
                h = layer_fn(lp, h)
            if sid == S - 1:              # the last stage emits
                outs[mb] = h
        if S == 1:
            buf = h
            continue
        buf = torch.empty_like(h)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, h.contiguous(), nxt, group),
                dist.P2POp(dist.irecv, buf, prev, group)]):
            req.wait()
    if S > 1:
        # only the last stage wrote its outputs: the sum gives them to all
        dist.all_reduce(outs, group=group)
    return outs


def pipeline_bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """GPipe bubble overhead: (S-1)/(M+S-1)."""
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
