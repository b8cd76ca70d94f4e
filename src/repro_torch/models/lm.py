"""Model assembly: one composable decoder covering all ten architectures,
the JAX package's ``repro.models.lm`` in PyTorch.

Families:
  dense / moe / vlm — transformer decoder; per-layer flags drive
        local:global attention (gemma3) and MoE (qwen3/mixtral); vlm
        (qwen2-vl) splices precomputed patch embeddings + M-RoPE.
  hybrid            — zamba2: Mamba2 backbone + a SHARED attention block
        applied every `shared_attn_every` layers (own KV slot per
        application).
  ssm               — rwkv6: attention-free WKV blocks.
  encdec            — seamless: bidirectional encoder over frame embeddings
        (stub frontend) + causal decoder w/ cross-attention.

Interface (pure functions, the reference's names and parameter trees):
  param_specs(cfg)                      -> ParamSpec tree
  init_cache_specs(cfg, B, S_max)       -> ParamSpec-like tree for caches
  forward(params, batch, cfg=..., ...)  -> (logits, new cache)
  loss_fn(params, batch, cfg=..., ...)  -> scalar loss

The reference scans over stacked layers (``jax.lax.scan``); here a Python
loop runs the layers, each leaf of the stacked parameters unbound once a
forward (``_unstack``: one ``stack`` in the backward, not a zero-filled
``[L, ...]`` gradient a layer).  ``cfg.scan_layers`` changes nothing.
``cfg.remat`` applies to the dense/moe/vlm decoder stack, as in the
reference's ``_maybe_remat``: ``"full"`` checkpoints each layer
(``torch.utils.checkpoint``, nothing saved inside), ``"selective"`` saves
the outputs of the layer's non-batched matmuls (``aten.mm``/``addmm``,
the projections) and recomputes the rest.  It changes no number; the
hybrid, ssm and encdec stacks ignore it, as the reference's do.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..parallel.sharding import MeshPolicy, shard_constraint
from .config import ModelConfig
from .layers import (_sdpa, apply_norm, apply_rope, attention_block,
                     attn_specs, embed, embed_specs, lm_head, mlp_block,
                     mlp_specs, norm_specs)
from .mamba2 import mamba2_block, mamba2_specs
from .moe import moe_apply, moe_specs
from .params import ParamSpec, tree_map
from .rwkv6 import rwkv6_att, rwkv6_ffn, rwkv6_specs


def _unstack(tree: Any, n: int) -> list:
    """The stacked ``[L, ...]`` parameters as ``n`` per-layer trees: each
    leaf unbound once (views; its backward is one ``stack``)."""
    cols = tree_map(lambda a: a.unbind(0), tree)
    return [tree_map(lambda t, i=i: t[i], cols) for i in range(n)]


def _save_projections(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, cfg: ModelConfig):
    """``fn`` under the reference's ``cfg.remat`` policy while gradients
    are recorded (a forward without them saves nothing anyway)."""
    if cfg.remat not in ("full", "selective"):
        return fn
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        if cfg.remat == "full":
            return checkpoint(fn, *args, use_reentrant=False)
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=lambda:
                          create_selective_checkpoint_contexts(
                              _save_projections))
    return wrapped


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


# ===========================================================================
# decoder transformer (dense / moe / vlm)
# ===========================================================================


def _layer_specs(cfg: ModelConfig) -> Dict[str, Any]:
    s: Dict[str, Any] = {"ln1": norm_specs(cfg), "ln2": norm_specs(cfg),
                         "attn": attn_specs(cfg)}
    if cfg.is_moe:
        s["moe"] = moe_specs(cfg)
    else:
        s["mlp"] = mlp_specs(cfg)
    return s


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    if cfg.family == "ssm":
        return _rwkv_param_specs(cfg)
    if cfg.family == "hybrid":
        return _hybrid_param_specs(cfg)
    if cfg.family == "encdec":
        return _encdec_param_specs(cfg)
    s = {"embed": embed_specs(cfg),
         "layers": _stack(_layer_specs(cfg), cfg.n_layers),
         "ln_f": norm_specs(cfg)}
    if cfg.family == "vlm":
        s["patch_proj"] = {
            "w": ParamSpec((cfg.d_model, cfg.d_model), ("embed", None))}
    return s


def _kv_specs(L: int, B: int, S_max: int, cfg: ModelConfig
              ) -> Dict[str, ParamSpec]:
    shape = (L, B, S_max, cfg.n_kv_heads, cfg.hd)
    axes = ("layers", "batch", "kv_seq", "kv_heads", None)
    return {"k": ParamSpec(shape, axes, "zeros"),
            "v": ParamSpec(shape, axes, "zeros")}


def init_cache_specs(cfg: ModelConfig, B: int, S_max: int) -> Any:
    """KV-cache / state trees as ParamSpecs (zeros init)."""
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
    if cfg.family == "hybrid":
        d_in = cfg.ssm_expand * d
        H = cfg.ssm_heads or max(1, d_in // 64)
        hd = d_in // H
        L, N, K = cfg.n_layers, cfg.ssm_state, cfg.ssm_conv
        n_apps = max(1, L // max(1, cfg.shared_attn_every))
        kv = cfg.n_kv_heads
        return {"h": ParamSpec((L, B, H, hd, N),
                               ("layers", "batch", None, None, "state"),
                               "zeros"),
                "conv": ParamSpec((L, B, K - 1, d_in + 2 * N),
                                  ("layers", "batch", None, None), "zeros"),
                "shared_k": ParamSpec((n_apps, B, S_max, kv, cfg.hd),
                                      (None, "batch", "kv_seq", "kv_heads",
                                       None), "zeros"),
                "shared_v": ParamSpec((n_apps, B, S_max, kv, cfg.hd),
                                      (None, "batch", "kv_seq", "kv_heads",
                                       None), "zeros")}
    if cfg.family == "encdec":
        return {**_kv_specs(cfg.n_dec_layers, B, S_max, cfg),
                "enc_out": ParamSpec((B, cfg.n_patches, d),
                                     ("batch", "frames", "act_embed"),
                                     "zeros")}
    return _kv_specs(cfg.n_layers, B, S_max, cfg)


def _decoder_stack(params: Dict[str, Any], x: torch.Tensor, *,
                   cfg: ModelConfig, policy: MeshPolicy, mesh: Any,
                   positions: torch.Tensor,
                   cache: Optional[Dict[str, torch.Tensor]] = None,
                   cache_index: Any = None, use_kernels: bool = False
                   ) -> Tuple[torch.Tensor, Any]:
    # numpy bools, never the literal True: the reference hands the layer a
    # traced array, so under the kernels its global layers keep the
    # sliding window (ROADMAP.md queue 3), and so do these
    flags = layer_flags(cfg)

    def layer(carry_x, lp, is_global, layer_cache):
        h = apply_norm(cfg, lp["ln1"], carry_x)
        a, new_cache = attention_block(
            lp["attn"], h, cfg=cfg, positions=positions, policy=policy,
            mesh=mesh, is_global=is_global, cache=layer_cache,
            cache_index=cache_index, use_kernels=use_kernels)
        if cfg.parallel_block:
            # command-r: x + attn(ln(x)) + mlp(ln(x)) with the same norm
            m = mlp_block(lp["mlp"], h, cfg=cfg, policy=policy, mesh=mesh)
            out = carry_x + a + m
        else:
            h2 = carry_x + a
            hn = apply_norm(cfg, lp["ln2"], h2)
            if cfg.is_moe:
                m = moe_apply(lp["moe"], hn, cfg=cfg, policy=policy,
                              mesh=mesh, use_kernels=use_kernels)
            else:
                m = mlp_block(lp["mlp"], hn, cfg=cfg, policy=policy,
                              mesh=mesh)
            out = h2 + m
        out = shard_constraint(out, ("batch", "seq", "act_embed"), policy,
                               mesh)
        return out, new_cache

    layer = _maybe_remat(layer, cfg)
    new_k, new_v = [], []
    for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
        layer_cache = None if cache is None else \
            {"k": cache["k"][i], "v": cache["v"][i]}
        x, new_cache = layer(x, lp, flags[i], layer_cache)
        if cache is not None:
            new_k.append(new_cache["k"])
            new_v.append(new_cache["v"])
    if cache is None:
        return x, None
    return x, {"k": torch.stack(new_k), "v": torch.stack(new_v)}


def _decoder_forward(params, batch, *, cfg, policy, mesh, cache=None,
                     cache_index=None, use_kernels=False):
    tokens = batch["tokens"]
    dtype = getattr(torch, cfg.dtype)
    x = embed(params["embed"], tokens, policy=policy, mesh=mesh, dtype=dtype)
    if cfg.family == "vlm" and "patch_embeds" in batch:
        # splice precomputed patch embeddings (frontend stub) over the
        # leading n_patches token positions
        pe = batch["patch_embeds"].to(dtype) @ \
            params["patch_proj"]["w"].to(dtype)
        x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
    B, S = tokens.shape
    dev = tokens.device
    if cfg.mrope:
        positions = batch.get("positions")
        if positions is None:
            pos1 = (torch.arange(S, device=dev)[None, :, None]
                    if cache_index is None else
                    torch.full((1, 1, 1), int(cache_index),
                               dtype=torch.int32, device=dev))
            positions = pos1.expand(B, S, 3)
    else:
        positions = (torch.arange(S, device=dev)[None, :]
                     if cache_index is None else
                     torch.full((B, S), int(cache_index), dtype=torch.int32,
                                device=dev))
        positions = positions.expand(B, S)
    x, new_cache = _decoder_stack(params, x, cfg=cfg, policy=policy,
                                  mesh=mesh, positions=positions,
                                  cache=cache, cache_index=cache_index,
                                  use_kernels=use_kernels)
    x = apply_norm(cfg, params["ln_f"], x)
    logits = lm_head(params["embed"], x, policy=policy, mesh=mesh)
    return logits, new_cache


def forward(params: Dict[str, Any], batch: Dict[str, Any], *,
            cfg: ModelConfig, policy: MeshPolicy = MeshPolicy(),
            mesh: Any = None, cache: Optional[Any] = None,
            cache_index: Any = None, use_kernels: bool = False,
            device: Union[str, torch.device, None] = None
            ) -> Tuple[torch.Tensor, Any]:
    """Returns (logits, new_cache). Train/prefill: cache_index None.

    Runs on the card unless ``device="cpu"`` is asked for; the parameters
    (and the cache) must already be there, the batch's arrays (tokens,
    vlm's ``patch_embeds`` and ``positions``, encdec's ``frames``) are
    moved there.  ``use_kernels`` is the reference's ``use_pallas``:
    prefill and scoring attention run the flash-attention kernel, MoE
    experts the grouped-matmul kernel, zamba2's Mamba2 layers the SSD
    kernel and rwkv6 the WKV kernel; their plain versions on the CPU."""
    dev = resolve_device(device)
    where = params["embed"]["tok"].device
    if where.type != dev.type:
        raise ValueError(f"forward on {dev}: the parameters are on {where}")
    batch = {k: v.to(where) if torch.is_tensor(v)
             else torch.tensor(np.asarray(v), device=where)
             for k, v in batch.items()}
    fwd = {"ssm": _rwkv_forward, "hybrid": _hybrid_forward,
           "encdec": _encdec_forward}.get(cfg.family, _decoder_forward)
    return fwd(params, batch, cfg=cfg, policy=policy, mesh=mesh,
               cache=cache, cache_index=cache_index, use_kernels=use_kernels)


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
    for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
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
    layers = _unstack(params["layers"], cfg.n_layers)
    for app in range(n_apps):
        for i in range(app * every, min((app + 1) * every, cfg.n_layers)):
            lp = layers[i]
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


# ===========================================================================
# seamless (encdec family)
# ===========================================================================


def _encdec_param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    enc_layer = {"ln1": norm_specs(cfg), "attn": attn_specs(cfg),
                 "ln2": norm_specs(cfg), "mlp": mlp_specs(cfg)}
    dec_layer = {"ln1": norm_specs(cfg), "attn": attn_specs(cfg),
                 "ln_x": norm_specs(cfg), "xattn": attn_specs(cfg),
                 "ln2": norm_specs(cfg), "mlp": mlp_specs(cfg)}
    return {"embed": embed_specs(cfg),
            "enc": _stack(enc_layer, cfg.n_enc_layers),
            "dec": _stack(dec_layer, cfg.n_dec_layers),
            "ln_enc": norm_specs(cfg), "ln_f": norm_specs(cfg)}


def _cross_attention(p, x, enc_out, *, cfg, policy, mesh):
    """Decoder queries over the encoder's output, unmasked (plain
    ``_sdpa``, as the reference)."""
    B, Sq, d = x.shape
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", enc_out, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", enc_out, p["wv"].to(dt))
    mask = torch.ones((B, Sq, enc_out.shape[1]), dtype=torch.bool,
                      device=x.device)
    out = _sdpa(q, k, v, mask, None)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt))


def _encoder_layer(lp, x, pos, *, cfg, policy, mesh):
    """Bidirectional self-attention with RoPE (plain ``_sdpa``), then the
    MLP; the reference's encoder layer."""
    h = apply_norm(cfg, lp["ln1"], x)
    B, S, _ = h.shape
    dt = h.dtype
    q = torch.einsum("bsd,dhk->bshk", h, lp["attn"]["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", h, lp["attn"]["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", h, lp["attn"]["wv"].to(dt))
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    a = _sdpa(q, k, v, torch.ones((B, S, S), dtype=torch.bool,
                                  device=h.device), None)
    a = torch.einsum("bshk,hkd->bsd", a, lp["attn"]["wo"].to(dt))
    x2 = x + a
    h2 = apply_norm(cfg, lp["ln2"], x2)
    return x2 + mlp_block(lp["mlp"], h2, cfg=cfg, policy=policy, mesh=mesh)


def _encdec_forward(params, batch, *, cfg, policy, mesh, cache=None,
                    cache_index=None, use_kernels=False):
    dtype = getattr(torch, cfg.dtype)
    decode = cache_index is not None
    # ---------------- encoder (skipped during decode: enc_out cached) ----
    if not decode:
        enc_out = batch["frames"].to(dtype)             # stub frontend
        Bf, Sf = enc_out.shape[:2]
        pos_e = torch.arange(Sf, device=enc_out.device)[None, :].expand(
            Bf, Sf)
        for lp in _unstack(params["enc"], cfg.n_enc_layers):
            enc_out = _encoder_layer(lp, enc_out, pos_e, cfg=cfg,
                                     policy=policy, mesh=mesh)
        enc_out = apply_norm(cfg, params["ln_enc"], enc_out)
    else:
        enc_out = cache["enc_out"].to(dtype)
    # ---------------- decoder -------------------------------------------
    tokens = batch["tokens"]
    x = embed(params["embed"], tokens, policy=policy, mesh=mesh, dtype=dtype)
    B, S = tokens.shape
    dev = tokens.device
    positions = (torch.arange(S, device=dev)[None, :] if not decode
                 else torch.full((B, S), int(cache_index),
                                 dtype=torch.int32, device=dev))
    positions = positions.expand(B, S)
    new_k, new_v = [], []
    for i, lp in enumerate(_unstack(params["dec"], cfg.n_dec_layers)):
        layer_cache = None if cache is None else \
            {"k": cache["k"][i], "v": cache["v"][i]}
        h = apply_norm(cfg, lp["ln1"], x)
        a, new_cache_l = attention_block(
            lp["attn"], h, cfg=cfg, positions=positions, policy=policy,
            mesh=mesh, is_global=True, cache=layer_cache,
            cache_index=cache_index, use_kernels=use_kernels)
        x2 = x + a
        hx = apply_norm(cfg, lp["ln_x"], x2)
        x3 = x2 + _cross_attention(lp["xattn"], hx, enc_out, cfg=cfg,
                                   policy=policy, mesh=mesh)
        h2 = apply_norm(cfg, lp["ln2"], x3)
        x = x3 + mlp_block(lp["mlp"], h2, cfg=cfg, policy=policy, mesh=mesh)
        if cache is not None:
            new_k.append(new_cache_l["k"])
            new_v.append(new_cache_l["v"])
    new_cache = None
    if cache is not None:
        new_cache = {"k": torch.stack(new_k), "v": torch.stack(new_v),
                     "enc_out": enc_out.to(cache["enc_out"].dtype)}
    x = apply_norm(cfg, params["ln_f"], x)
    logits = lm_head(params["embed"], x, policy=policy, mesh=mesh)
    return logits, new_cache


# ===========================================================================
# loss
# ===========================================================================


def nll_terms(params: Dict[str, Any], batch: Dict[str, Any], *,
              cfg: ModelConfig, policy: MeshPolicy = MeshPolicy(),
              mesh: Any = None, use_kernels: bool = False,
              device: Union[str, torch.device, None] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the next-token NLL over the labels ``>= 0``, their count),
    fp32; :func:`loss_fn` is their ratio.  fp32 logits, logsumexp about
    the detached max.  The reference takes the gold logit as a one-hot
    sum, so that a vocab sharded over a mesh needs no all-gather; on one
    card ``torch.gather`` of the clamped labels gives the same value (the
    one-hot sum adds one logit to zeros) without two ``[B, S, V]``
    temporaries."""
    logits, _ = forward(params, batch, cfg=cfg, policy=policy, mesh=mesh,
                        use_kernels=use_kernels, device=device)
    labels = batch["labels"]
    labels = (labels if torch.is_tensor(labels) else torch.from_numpy(
        np.asarray(labels))).to(logits.device).long()
    lf = logits.float()
    m = lf.amax(-1, keepdim=True).detach()
    logz = torch.log(torch.exp(lf - m).sum(-1)) + m.squeeze(-1)
    gold = torch.gather(lf, -1, labels.clamp_min(0)[..., None]).squeeze(-1)
    mask = (labels >= 0).float()
    nll = (logz - gold) * mask
    return nll.sum(), mask.sum()


def loss_fn(params: Dict[str, Any], batch: Dict[str, Any], *,
            cfg: ModelConfig, policy: MeshPolicy = MeshPolicy(),
            mesh: Any = None, use_kernels: bool = False,
            device: Union[str, torch.device, None] = None) -> torch.Tensor:
    """Mean next-token NLL over the labels ``>= 0`` (the reference's
    ``loss_fn``), from :func:`nll_terms`."""
    total, count = nll_terms(params, batch, cfg=cfg, policy=policy,
                             mesh=mesh, use_kernels=use_kernels,
                             device=device)
    return total / count.clamp_min(1.0)
