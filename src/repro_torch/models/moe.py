"""Mixture-of-Experts layer: token-choice top-k routing, the JAX package's
``repro.models.moe`` in PyTorch, with its names and parameter layout
(``router [d, E]``, ``wi``/``wg [E, d, f]``, ``wo [E, f, d]``).

On one card :func:`moe_apply` takes the dense route (:func:`moe_dense`),
as the reference does without a mesh: every token goes through every
expert and the top-k outputs are gathered and weighted.  Under
``use_kernels`` the experts' three matmuls go through
``kernels.moe_gmm.ops.gmm`` (the CUDA kernel for CUDA tensors, its plain
version for CPU tensors).  The capacity-buffer helpers
(:func:`_dispatch`, :func:`_combine`) are the expert- and
tensor-parallel routes' building blocks; those routes themselves
(``all_to_all`` and ``psum`` inside ``shard_map`` in the reference) wait
for multi-device, and any mesh raises, as ``shard_constraint`` does.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..parallel.sharding import MeshPolicy
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


def moe_apply(p: Dict[str, Any], x: torch.Tensor, *, cfg: ModelConfig,
              policy: MeshPolicy, mesh: Any = None,
              use_kernels: bool = False) -> torch.Tensor:
    """The dense route on one card (``mesh is None``), as the reference
    without a mesh; its routes over a device mesh are not ported."""
    if mesh is not None:
        raise NotImplementedError(
            "the MoE routes over a device mesh (all_to_all, psum) are not "
            "ported yet (ROADMAP.md queue 1 item 3, multi-device)")
    return moe_dense(p, x, cfg, use_kernels=use_kernels)
