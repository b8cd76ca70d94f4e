"""Mixture-of-Experts layer: token-choice top-k routing, the JAX package's
``repro.models.moe`` in PyTorch, with its names and parameter layout
(``router [d, E]``, ``wi``/``wg [E, d, f]``, ``wo [E, f, d]``), and its
three routes, chosen by :func:`moe_route` from the mesh as there:

  * **dense** (no mesh, or a `model` axis of 1): every token goes through
    every expert and the top-k outputs are gathered and weighted
    (:func:`moe_dense`), the oracle of the others.
  * **EP (expert parallel)**, when the `model` axis divides the experts:
    each rank holds ``E / M`` experts; the capacity buffers
    ``[M, E_loc, C, d]`` go out and back by ``all_to_all_single`` over the
    mesh's `model` group (qwen3-moe: 128 experts / 4 = 32 a card).
  * **TP (tensor parallel)** otherwise: each rank holds every expert's
    slice of the hidden dim; the down-projection is summed by
    ``all_reduce`` (mixtral's 8 experts on a 16-way axis).

:func:`moe_pspecs` says which slice of each expert leaf a route computes
on, and the routes check the shards they are handed against it.  The
parameters are stored as ``parallel.sharding.storage_pspecs`` lays them
out; the model (``models.lm``) gathers the experts' `embed` dimension over
`data` (FSDP) and the router over `model` at the layer's entry, as GSPMD
does at the reference's ``shard_map`` boundary, so a route sees the
router whole.  Under ``use_kernels`` the experts' three matmuls go
through ``kernels.moe_gmm.ops.gmm`` on the rank's local experts (the CUDA
kernel for CUDA tensors, its plain version for CPU tensors).

The collectives are the autograd-aware ones
(``torch.distributed.nn.functional``), and the route's inputs and output
carry the transpose rules of the reference's ``shard_map``: every rank
computes the same loss from the same tokens, so a rank's gradient of the
route's output counts 1/M (:class:`_ToReplicated`) and the gradients of
the replicated inputs, tokens and router, are summed over the group
(:class:`_FromReplicated`); both are ``parallel.sharding``'s, shared with
the dense regions.  Each rank then holds the whole gradient of the
replicated leaves and its experts' share, as ``jax.grad`` gives.

One departure: the reference's EP reshapes the exchanged
``[M, E_loc, C, d]`` buffer to ``[E_loc, M * C, d]`` without moving the
source axis behind the expert axis, so with ``E_loc > 1`` a local expert
runs other experts' tokens and the ranks' outputs differ (ROADMAP.md
queue 3).  Here the source axis is moved first: each token goes through
its own expert, and the route equals ``_dispatch``, every expert, then
``_combine`` on one device, on every rank alike.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..parallel.sharding import (MeshPolicy, P, _FromReplicated,
                                 _ToReplicated, is_device_mesh, mesh_shape)
from .config import ModelConfig
from .params import ParamSpec


def moe_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, f, e = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.n_experts
    return {
        "router": ParamSpec((d, e), ("embed", "experts")),
        "wi": ParamSpec((e, d, f), ("experts", "embed", "expert_mlp")),
        "wg": ParamSpec((e, d, f), ("experts", "embed", "expert_mlp")),
        "wo": ParamSpec((e, f, d), ("experts", "expert_mlp", "embed")),
    }


def _router(p: Dict[str, Any], x: torch.Tensor, k: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (weights [.., k], experts [.., k]); weights softmaxed over
    the selected k (qwen3/mixtral convention).  The logits are fp32 from
    operands in x's dtype (the reference's ``preferred_element_type``).
    Tied logits keep the lower expert first, as ``jax.lax.top_k`` does:
    ``torch.topk`` does not specify its order among ties, so the top k are
    taken from a stable descending sort."""
    logits = x.float() @ p["router"].to(x.dtype).float()
    top, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    top, idx = top[..., :k], idx[..., :k]
    w = torch.softmax(top, dim=-1)
    return w.to(x.dtype), idx


def _expert_ffn(p: Dict[str, Any], h: torch.Tensor, which: Any = slice(None),
                use_kernels: bool = False) -> torch.Tensor:
    """h: [E?, C, d] -> [E?, C, d] through each expert's SwiGLU.

    ``use_kernels`` runs the three matmuls as grouped matmuls
    (``ops.gmm``, fp32 sums, the result in h's dtype); ``h`` is made
    contiguous once and the same tensor feeds both input projections."""
    dt = h.dtype
    wi, wg, wo = (p[n][which].to(dt) for n in ("wi", "wg", "wo"))
    if not use_kernels:
        a = torch.einsum("ecd,edf->ecf", h, wi)
        g = torch.einsum("ecd,edf->ecf", h, wg)
        return torch.einsum("ecf,efd->ecd", F.silu(g) * a, wo)
    from ..kernels.moe_gmm import ops as gmm_ops
    h = h.contiguous()
    a = gmm_ops.gmm(h, wi)
    g = gmm_ops.gmm(h, wg)
    del h, wi, wg
    return gmm_ops.gmm(F.silu(g) * a, wo)


# ---------------------------------------------------------------------------
# dense route (no collectives): every token through all experts, then a
# gather of each token's k outputs.  O(E/k) extra work; the one-card route
# and the oracle of the others.
# ---------------------------------------------------------------------------


def moe_dense(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig,
              use_kernels: bool = False) -> torch.Tensor:
    B, S, d = x.shape
    E, T = cfg.n_experts, B * S
    w, idx = _router(p, x, cfg.experts_per_token)        # [B,S,k]
    xt = x.reshape(1, T, d).expand(E, T, d)
    ys = _expert_ffn(p, xt, use_kernels=use_kernels)     # [E,T,d]
    # the reference's take_along_axis over the expert axis, as one gather
    sel = ys[idx.reshape(T, -1), torch.arange(T, device=x.device)[:, None]]
    sel = sel.reshape(B, S, -1, d)                       # [B,S,k,d]
    return torch.sum(sel * w[..., None], dim=2)


# ---------------------------------------------------------------------------
# capacity-buffer dispatch (the expert- and tensor-parallel routes' helpers)
# ---------------------------------------------------------------------------


def _dispatch(x2: torch.Tensor, w: torch.Tensor, idx: torch.Tensor, E: int,
              C: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """x2 [T,d]; w/idx [T,k]. Scatter tokens into per-expert capacity
    buffers. Returns (buffers [E,C,d], keep mask [T,k], pos [T,k], w)."""
    T, k = idx.shape
    flat_e = idx.reshape(-1).long()                      # [T*k]
    onehot = F.one_hot(flat_e, E).to(torch.int32)        # [T*k, E]
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) * onehot
    pos_in_e = (pos.sum(-1, dtype=torch.int32) - 1).reshape(T, k)
    keep = pos_in_e < C
    buf = torch.zeros((E, C, x2.shape[-1]), dtype=x2.dtype, device=x2.device)
    tok_idx = torch.arange(T, device=x2.device)[:, None].expand(T, k)
    e_safe = torch.where(keep, idx.long(), 0)
    p_safe = torch.where(keep, pos_in_e, C - 1).long()
    rows = torch.where(keep.reshape(-1)[:, None], x2[tok_idx.reshape(-1)],
                       torch.zeros((), dtype=x2.dtype, device=x2.device))
    buf.index_put_((e_safe.reshape(-1), p_safe.reshape(-1)), rows,
                   accumulate=True)
    return buf, keep, pos_in_e, w


def _combine(y_buf: torch.Tensor, idx: torch.Tensor, pos: torch.Tensor,
             keep: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y_buf [E,C,d] -> per-token combine [T,d]."""
    e_safe = torch.where(keep, idx.long(), 0)
    p_safe = torch.where(keep, pos, 0).long()
    gathered = y_buf[e_safe.reshape(-1), p_safe.reshape(-1)]  # [T*k, d]
    T, k = idx.shape
    gathered = gathered.reshape(T, k, -1)
    gathered = torch.where(keep[..., None], gathered,
                           torch.zeros((), dtype=gathered.dtype,
                                       device=gathered.device))
    return torch.sum(gathered * w[..., None], dim=1)


def moe_route(cfg: ModelConfig, mesh: Any = None) -> str:
    """``"dense"``, ``"ep"`` or ``"tp"``: the reference's dispatch on the
    mesh's `model` axis."""
    if mesh is None:
        return "dense"
    if not is_device_mesh(mesh):
        raise TypeError(f"moe_apply: {type(mesh).__name__} is not a "
                        f"torch.distributed DeviceMesh")
    M = mesh_shape(mesh).get("model", 1)
    if M == 1:
        return "dense"
    return "ep" if cfg.n_experts % M == 0 else "tp"


def moe_pspecs(axes_tree: Any, cfg: ModelConfig, mesh: Any = None) -> Any:
    """Each leaf's PartitionSpec over `model` as the MoE routes compute on
    the parameters on ``mesh`` (the reference's ``shard_map`` in_specs):
    the experts' weights (the leaves with an ``expert_mlp`` axis) split
    over `model` by expert (EP) or by hidden dim (TP); everything else, the
    router included, whole.  Not the storage layout
    (``parallel.sharding.storage_pspecs``): the routes check their shards
    against it."""
    split = {"ep": "experts", "tp": "expert_mlp"}.get(moe_route(cfg, mesh))

    def spec(axes):
        if split is not None and "expert_mlp" in axes:
            return P(*("model" if a == split else None for a in axes))
        return P(*(None,) * len(axes))

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return spec(t)

    return walk(axes_tree)


def moe_apply(p: Dict[str, Any], x: torch.Tensor, *, cfg: ModelConfig,
              policy: MeshPolicy, mesh: Any = None,
              use_kernels: bool = False) -> torch.Tensor:
    """Dispatch to EP / TP / dense based on mesh shape; ``p`` holds this
    rank's experts as they are stored and the whole router, ``x`` this
    rank's tokens.  Experts stored split by their hidden units take the TP
    route, split by expert the EP route; experts stored whole (a policy
    that does not split them) take the route :func:`moe_route` picks, on
    this rank's slice of them (:func:`moe_pspecs`), their gradient summed
    over the group."""
    route = moe_route(cfg, mesh)
    if route == "dense":
        return moe_dense(p, x, cfg, use_kernels=use_kernels)
    group = mesh.get_group("model")
    E, f = cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
    if p["wi"].shape[-1] < f:
        route = "tp"
    elif p["wi"].shape[0] < E:
        route = "ep"
    else:
        import torch.distributed as dist
        M, r = group.size(), dist.get_rank(group)
        p = dict(p)
        for name, dim in (("wi", 2), ("wg", 2), ("wo", 1)):
            w = _FromReplicated.apply(p[name], group)
            if route == "ep":
                p[name] = w.narrow(0, r * (E // M), E // M)
            else:
                p[name] = w.narrow(dim, r * (f // M), f // M)
    route_fn = _moe_ep if route == "ep" else _moe_tp
    return route_fn(p, x, cfg, group, use_kernels)


def _capacity(T: int, k: int, E: int, capacity_factor: float) -> int:
    return max(8, int(math.ceil(T * k / E * capacity_factor)))


def _route_in(p, x, cfg: ModelConfig, group):
    """The routes' common front: the replicated inputs marked, the router,
    and the tokens in capacity buffers ``[E, C, d]``."""
    x = _FromReplicated.apply(x, group)
    router = _FromReplicated.apply(p["router"], group)
    B, S, d = x.shape
    T, k, E = B * S, cfg.experts_per_token, cfg.n_experts
    C = _capacity(T, k, E, cfg.capacity_factor)
    w, idx = _router({"router": router}, x, k)
    idx = idx.reshape(T, k)
    buf, keep, pos, w2 = _dispatch(x.reshape(T, d), w.reshape(T, k), idx,
                                   E, C)
    return buf, (idx, pos, keep, w2)


def _route_out(y_buf, combine_args, shape, group):
    out = _combine(y_buf, *combine_args).reshape(shape)
    return _ToReplicated.apply(out, group.size())


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    from torch.distributed.nn.functional import all_to_all_single
    t = t.contiguous()
    return all_to_all_single(torch.empty_like(t), t, group=group)


def _moe_ep(p, x, cfg: ModelConfig, group, use_kernels: bool
            ) -> torch.Tensor:
    """Expert parallelism over the `model` group with all_to_all."""
    E, M = cfg.n_experts, group.size()
    E_loc = E // M
    if p["wi"].shape[0] != E_loc:
        raise ValueError(f"EP on {M} ranks: each holds {E_loc} of {E} "
                         f"experts, not {p['wi'].shape[0]} (moe_pspecs)")
    d = x.shape[-1]
    buf, combine_args = _route_in(p, x, cfg, group)
    C = buf.shape[1]
    # exchange: [E, C, d] -> [M, E_loc, C, d]; block m goes to rank m and
    # comes back as [M (source), E_loc, C, d]
    buf = _all_to_all(buf.reshape(M, E_loc, C, d), group)
    h = buf.transpose(0, 1).reshape(E_loc, M * C, d)
    y = _expert_ffn(p, h, use_kernels=use_kernels)       # local experts
    y = _all_to_all(y.reshape(E_loc, M, C, d).transpose(0, 1), group)
    return _route_out(y.reshape(E, C, d), combine_args, x.shape, group)


def _moe_tp(p, x, cfg: ModelConfig, group, use_kernels: bool
            ) -> torch.Tensor:
    """Tensor parallelism: all experts on every rank, hidden dim sharded
    over `model`; all_reduce sums the down-projection."""
    from torch.distributed.nn.functional import all_reduce
    f, M = cfg.moe_d_ff or cfg.d_ff, group.size()
    if p["wi"].shape[-1] * M != f:
        raise ValueError(f"TP on {M} ranks: each holds {f // M} of the "
                         f"{f} hidden units, not {p['wi'].shape[-1]} "
                         f"(moe_pspecs)")
    buf, combine_args = _route_in(p, x, cfg, group)
    y_buf = _expert_ffn(p, buf, use_kernels=use_kernels)  # sharded hidden
    y_buf = all_reduce(y_buf, group=group)
    return _route_out(y_buf, combine_args, x.shape, group)
