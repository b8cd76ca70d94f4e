"""Model assembly: the JAX package's ``repro.models.lm`` in PyTorch, as far
as the port has come.

Ported families:
  hybrid            — zamba2: Mamba2 backbone + a SHARED attention block
        applied every `shared_attn_every` layers (own KV slot per
        application).
  ssm               — rwkv6: attention-free WKV blocks.

The other families (dense / moe / vlm, encdec) raise
``NotImplementedError`` naming the ROADMAP.md item that ports them.

Interface (pure functions, the reference's names and parameter trees):
  param_specs(cfg)                      -> ParamSpec tree
  init_cache_specs(cfg, B, S_max)       -> ParamSpec-like tree for caches
  forward(params, batch, cfg=..., ...)  -> (logits, new cache)

The reference scans over stacked layers (``jax.lax.scan``); here a Python
loop indexes the stacked parameters layer by layer.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..parallel.sharding import MeshPolicy
from .config import ModelConfig
from .layers import (apply_norm, attention_block, attn_specs, embed,
                     embed_specs, lm_head, mlp_block, mlp_specs, norm_specs)
from .mamba2 import mamba2_block, mamba2_specs
from .params import ParamSpec, tree_map
from .rwkv6 import rwkv6_att, rwkv6_ffn, rwkv6_specs

#: where each family not yet ported stands in ROADMAP.md
_NOT_PORTED = {
    "dense": "ROADMAP.md queue 1 item 4: the model stack's other families",
    "moe": "ROADMAP.md queue 1 item 4: the model stack's other families",
    "vlm": "ROADMAP.md queue 1 item 4: the model stack's other families",
    "encdec": "ROADMAP.md queue 1 item 4: the model stack's other families",
}


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in ("hybrid", "ssm"):
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: "
            f"{_NOT_PORTED.get(cfg.family, _NOT_PORTED['dense'])}")


def _stack(specs: Any, L: int) -> Any:
    """Prepend a stacked `layers` axis to every leaf spec."""
    return tree_map(lambda s: ParamSpec((L,) + s.shape, ("layers",) + s.axes,
                                        s.init, s.scale), specs)


def layer_flags(cfg: ModelConfig) -> np.ndarray:
    """Per-layer is_global flags (gemma3 5:1 local:global; SWA archs are
    all-local; others all-global)."""
    L = cfg.n_layers
    if cfg.global_interval:
        return np.asarray([(i % cfg.global_interval) ==
                           (cfg.global_interval - 1) for i in range(L)])
    if cfg.sliding_window:
        return np.zeros(L, bool)
    return np.ones(L, bool)


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    _require_ported(cfg)
    if cfg.family == "ssm":
        return _rwkv_param_specs(cfg)
    return _hybrid_param_specs(cfg)


def init_cache_specs(cfg: ModelConfig, B: int, S_max: int) -> Any:
    """KV-cache / state trees as ParamSpecs (zeros init)."""
    _require_ported(cfg)
    d = cfg.d_model
    if cfg.family == "ssm":
        H, hd = d // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        L = cfg.n_layers
        return {"wkv": ParamSpec((L, B, H, hd, hd),
                                 ("layers", "batch", "heads", None, None),
                                 "zeros"),
                "shift_a": ParamSpec((L, B, 1, d),
                                     ("layers", "batch", None, "act_embed"),
                                     "zeros"),
                "shift_f": ParamSpec((L, B, 1, d),
                                     ("layers", "batch", None, "act_embed"),
                                     "zeros")}
    d_in = cfg.ssm_expand * d
    H = cfg.ssm_heads or max(1, d_in // 64)
    hd = d_in // H
    L, N, K = cfg.n_layers, cfg.ssm_state, cfg.ssm_conv
    n_apps = max(1, L // max(1, cfg.shared_attn_every))
    kv = cfg.n_kv_heads
    return {"h": ParamSpec((L, B, H, hd, N),
                           ("layers", "batch", None, None, "state"), "zeros"),
            "conv": ParamSpec((L, B, K - 1, d_in + 2 * N),
                              ("layers", "batch", None, None), "zeros"),
            "shared_k": ParamSpec((n_apps, B, S_max, kv, cfg.hd),
                                  (None, "batch", "kv_seq", "kv_heads", None),
                                  "zeros"),
            "shared_v": ParamSpec((n_apps, B, S_max, kv, cfg.hd),
                                  (None, "batch", "kv_seq", "kv_heads", None),
                                  "zeros")}


def forward(params: Dict[str, Any], batch: Dict[str, Any], *,
            cfg: ModelConfig, policy: MeshPolicy = MeshPolicy(),
            mesh: Any = None, cache: Optional[Any] = None,
            cache_index: Any = None, use_kernels: bool = False,
            device: Union[str, torch.device, None] = None
            ) -> Tuple[torch.Tensor, Any]:
    """Returns (logits, new_cache). Train/prefill: cache_index None.

    Runs on the card unless ``device="cpu"`` is asked for; the parameters
    (and the cache) must already be there, the tokens are moved there.
    ``use_kernels`` is the reference's ``use_pallas``: prefill and scoring
    run the flash-attention and SSD kernels (zamba2) or the WKV kernel
    (rwkv6), their plain versions on the CPU."""
    _require_ported(cfg)
    dev = resolve_device(device)
    where = params["embed"]["tok"].device
    if where.type != dev.type:
        raise ValueError(f"forward on {dev}: the parameters are on {where}")
    tokens = torch.as_tensor(batch["tokens"], device=where)
    fwd = _rwkv_forward if cfg.family == "ssm" else _hybrid_forward
    return fwd(params, {**batch, "tokens": tokens}, cfg=cfg,
                           policy=policy, mesh=mesh, cache=cache,
                           cache_index=cache_index, use_kernels=use_kernels)


# ===========================================================================
# rwkv6 (ssm family)
# ===========================================================================


def _rwkv_param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    per_layer = dict(rwkv6_specs(cfg))
    per_layer["ln1"] = norm_specs(cfg)
    per_layer["ln2"] = norm_specs(cfg)
    return {"embed": embed_specs(cfg),
            "layers": _stack(per_layer, cfg.n_layers),
            "ln_f": norm_specs(cfg)}


def _rwkv_forward(params, batch, *, cfg, policy, mesh, cache=None,
                  cache_index=None, use_kernels=False):
    """The reference's ``_rwkv_forward``; its norms are ``rmsnorm`` with
    the layernorm's ``scale`` (see ``models/rwkv6.py``)."""
    from .layers import rmsnorm
    tokens = batch["tokens"]
    dtype = getattr(torch, cfg.dtype)
    x = embed(params["embed"], tokens, policy=policy, mesh=mesh, dtype=dtype)
    decode = cache_index is not None
    stateful = cache is not None or decode
    new = {"wkv": [], "shift_a": [], "shift_f": []}
    for i in range(cfg.n_layers):
        lp = tree_map(lambda a, i=i: a[i], params["layers"])
        st = {key: cache[key][i] for key in new} if stateful else None
        h = rmsnorm(x, lp["ln1"]["scale"], cfg.norm_eps)
        a, st_a = rwkv6_att(lp["att"], h, cfg=cfg, policy=policy, mesh=mesh,
                            state=st, decode=decode, use_kernels=use_kernels)
        x = x + a
        h2 = rmsnorm(x, lp["ln2"]["scale"], cfg.norm_eps)
        f, new_sf = rwkv6_ffn(lp["ffn"], h2, cfg=cfg, policy=policy,
                              mesh=mesh, state=st)
        x = x + f
        if stateful:
            new["wkv"].append(st_a["wkv"])
            new["shift_a"].append(st_a["shift_a"])
            new["shift_f"].append(new_sf)
    new_cache = {key: torch.stack(v) for key, v in new.items()} \
        if stateful else None
    x = rmsnorm(x, params["ln_f"]["scale"], cfg.norm_eps)
    logits = lm_head(params["embed"], x, policy=policy, mesh=mesh)
    return logits, new_cache


# ===========================================================================
# zamba2 (hybrid family)
# ===========================================================================


def _hybrid_param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    per_layer = {"ln1": norm_specs(cfg), "mamba": mamba2_specs(cfg),
                 "ln2": norm_specs(cfg), "mlp": mlp_specs(cfg)}
    shared = {"ln1": norm_specs(cfg), "attn": attn_specs(cfg),
              "ln2": norm_specs(cfg), "mlp": mlp_specs(cfg)}
    return {"embed": embed_specs(cfg),
            "layers": _stack(per_layer, cfg.n_layers),
            "shared": shared,
            "ln_f": norm_specs(cfg)}


def _hybrid_forward(params, batch, *, cfg, policy, mesh, cache=None,
                    cache_index=None, use_kernels=False):
    tokens = batch["tokens"]
    dtype = getattr(torch, cfg.dtype)
    x = embed(params["embed"], tokens, policy=policy, mesh=mesh, dtype=dtype)
    decode = cache_index is not None
    B, S = tokens.shape
    every = max(1, cfg.shared_attn_every)
    dev = tokens.device
    positions = (torch.arange(S, device=dev)[None, :] if not decode
                 else torch.zeros((B, S), dtype=torch.int32, device=dev)
                 + int(cache_index))
    positions = positions.expand(B, S)

    def mamba_layer(x_in, lp, st):
        h = apply_norm(cfg, lp["ln1"], x_in)
        m, new_st = mamba2_block(lp["mamba"], h, cfg=cfg, policy=policy,
                                 mesh=mesh, state=st, decode=decode,
                                 use_kernels=use_kernels)
        x2 = x_in + m
        h2 = apply_norm(cfg, lp["ln2"], x2)
        x3 = x2 + mlp_block(lp["mlp"], h2, cfg=cfg, policy=policy,
                            mesh=mesh)
        return x3, new_st

    c = cache
    # the mamba backbone; shared attention applied after every `every`
    # layers (the reference's scan segments, here a loop over layers)
    n_apps = max(1, cfg.n_layers // every)
    new_h, new_conv = [], []
    new_sk, new_sv = [], []
    for app in range(n_apps):
        for i in range(app * every, min((app + 1) * every, cfg.n_layers)):
            lp = tree_map(lambda a, i=i: a[i], params["layers"])
            if c is not None or decode:
                x, st = mamba_layer(x, lp, {"h": c["h"][i],
                                            "conv": c["conv"][i]})
                new_h.append(st["h"])
                new_conv.append(st["conv"])
            else:
                x, _ = mamba_layer(x, lp, None)
        # shared attention block (same params every application)
        sp = params["shared"]
        hh = apply_norm(cfg, sp["ln1"], x)
        app_cache = None
        if c is not None:
            app_cache = {"k": c["shared_k"][app], "v": c["shared_v"][app]}
        a, new_app_cache = attention_block(
            sp["attn"], hh, cfg=cfg, positions=positions, policy=policy,
            mesh=mesh, is_global=True, cache=app_cache,
            cache_index=cache_index, use_kernels=use_kernels)
        x = x + a
        h2 = apply_norm(cfg, sp["ln2"], x)
        x = x + mlp_block(sp["mlp"], h2, cfg=cfg, policy=policy, mesh=mesh)
        if c is not None and new_app_cache is not None:
            new_sk.append(new_app_cache["k"])
            new_sv.append(new_app_cache["v"])
    new_cache = None
    if c is not None:
        new_cache = {"h": torch.stack(new_h) if new_h else c["h"],
                     "conv": torch.stack(new_conv) if new_conv
                     else c["conv"],
                     "shared_k": torch.stack(new_sk) if new_sk
                     else c["shared_k"],
                     "shared_v": torch.stack(new_sv) if new_sv
                     else c["shared_v"]}
    x = apply_norm(cfg, params["ln_f"], x)
    logits = lm_head(params["embed"], x, policy=policy, mesh=mesh)
    return logits, new_cache
