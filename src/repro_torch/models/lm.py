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
  forward(params, batch, cfg=..., ...)  -> (logits, new cache; written
                                           into a copy of the cache, or
                                           into its own storage with
                                           donate_cache)
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
from ..parallel.sharding import (KV_CACHE_AXES, Gather, MeshPolicy, _names,
                                 all_gather_dim, batch_mesh_axes,
                                 gather_tree, mesh_shape, model_part,
                                 reduce_over, regather_saved,
                                 shard_constraint, storage_pspecs)
from ..spans import span
from .config import ModelConfig
from .layers import (_sdpa, _tp_heads, apply_norm, apply_rope,
                     attention_block, attn_specs, embed, embed_specs,
                     from_replicated, lm_head, mlp_block, mlp_specs,
                     norm_specs)
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


#: the stacked subtrees: their leaves carry a leading `layers` axis
_STACKS = ("layers", "enc", "dec")


def _whole_on_use(path: Tuple[str, ...], axes: Tuple[Any, ...]) -> bool:
    """Leaves the port computes on whole though the reference splits them
    over `model`: rwkv6's time-mix projections (``heads_flat``; at d =
    2,560 over 16 ranks a 64-wide head would be cut in two), mamba2's
    ``norm`` and ``out_proj`` (its scan runs whole heads) and the MoE
    router (the routes read every expert's logit)."""
    return "heads_flat" in axes or "mamba" in path or path[-1] == "router"


def use_plans(cfg: ModelConfig, policy: MeshPolicy, mesh: Any) -> Any:
    """Each parameter's gathers on use on ``mesh`` (a tree like
    ``param_specs(cfg)``, each leaf a ``Gather`` or None), or None where
    no leaf is gathered.  Every split but a `model` split the blocks
    compute on is gathered; a gather over a mesh axis that splits the
    batch's rows sums the gradient back (FSDP), any other takes this
    rank's block of it.  Leaves of two dimensions or more are gathered in
    the compute dtype (the blocks cast them to it), the embedding table in
    its own (its lookup's gradient adds rows in fp32)."""
    if mesh is None:
        return None
    specs = param_specs(cfg)
    pspecs = storage_pspecs(specs, policy, mesh)
    rows = set(batch_mesh_axes(policy, mesh))
    dt = getattr(torch, cfg.dtype)
    sizes = mesh_shape(mesh)
    found = []

    def plan(path, s, ps):
        if isinstance(s, dict):
            return {k: plan(path + (k,), v, ps[k]) for k, v in s.items()}
        lead = 1 if path[0] in _STACKS else 0
        steps = []
        for dim, entry in enumerate(ps):
            for name in reversed(_names(entry)):       # the minor axis first
                if sizes[name] == 1 or (name == "model" and
                                        not _whole_on_use(path, s.axes)):
                    continue
                steps.append((dim - lead, mesh.get_group(name),
                              name in rows))
        if not steps:
            return None
        found.append(path)
        cast = len(s.shape) - lead >= 2 and path[-1] != "tok"
        return Gather(tuple(steps), dt if cast else None)

    plans = plan((), specs, pspecs)
    return plans if found else None


def _take(params: Dict[str, Any], plans: Any, key: str,
          only: Tuple[str, ...] = ()) -> Any:
    """``params[key]`` gathered for use by its plans (of its subtree,
    the keys in ``only`` where given)."""
    tree = params[key]
    if only:
        tree = {k: tree[k] for k in only if k in tree}
    return tree if plans is None else gather_tree(tree, plans[key])


def _sub(plans: Any, key: str) -> Any:
    return None if plans is None else plans[key]


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
    return {"k": ParamSpec(shape, KV_CACHE_AXES, "zeros"),
            "v": ParamSpec(shape, KV_CACHE_AXES, "zeros")}


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
                   cache_index: Any = None, use_kernels: bool = False,
                   plans: Any = None) -> Tuple[torch.Tensor, Any]:
    """The decoder layers; ``plans`` the stacked leaves' gathers
    (:func:`use_plans`' ``["layers"]``), made inside each layer's region."""
    # numpy bools, never the literal True: the reference hands the layer a
    # traced array, so under the kernels its global layers keep the
    # sliding window (ROADMAP.md queue 3), and so do these
    flags = layer_flags(cfg)

    def layer(carry_x, lp, is_global, layer_cache):
        if plans is not None:
            lp = gather_tree(lp, plans)
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
    for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
        # layer i's rows of the stacked cache: written where they lie
        layer_cache = None if cache is None else \
            {"k": cache["k"][i], "v": cache["v"][i]}
        x, _ = layer(x, lp, flags[i], layer_cache)
    return x, cache


def _store(cache: Dict[str, torch.Tensor], key: str, i: int,
           new: torch.Tensor, promoted: Dict[str, list]) -> None:
    """Layer ``i``'s new state ``new`` of the stacked ``cache[key]``:
    written into the cache's own storage where it has the leaf's dtype;
    else kept in ``promoted[key]``, to be stacked into a new leaf (the
    reference's new state is promoted there: a bf16 state stepped in
    fp32 comes back fp32, and XLA aliases no donated buffer of another
    type either)."""
    if new.dtype == cache[key].dtype:
        cache[key][i].copy_(new)
    else:
        promoted.setdefault(key, []).append(new)


def _with_promoted(cache: Dict[str, torch.Tensor],
                   promoted: Dict[str, list]) -> Dict[str, torch.Tensor]:
    return {**cache, **{k: torch.stack(v) for k, v in promoted.items()}}


def _embed(params, plans, tokens, *, cfg, policy, mesh, dtype):
    return embed(_take(params, plans, "embed", ("tok",)), tokens,
                 policy=policy, mesh=mesh, dtype=dtype,
                 vocab_size=cfg.vocab_size)


def _logits(params, plans, x, *, cfg, policy, mesh):
    """The LM head on the normed ``x``: the untied ``head`` or the tied
    table, gathered alone."""
    head = ("tok",) if cfg.tie_embeddings else ("head",)
    with span("lm.head", x):
        return lm_head(_take(params, plans, "embed", head), x,
                       policy=policy, mesh=mesh, vocab_size=cfg.vocab_size)


def _head(params, plans, x, *, cfg, policy, mesh):
    x = apply_norm(cfg, _take(params, plans, "ln_f"), x)
    return _logits(params, plans, x, cfg=cfg, policy=policy, mesh=mesh)


def _decoder_forward(params, batch, *, cfg, policy, mesh, cache=None,
                     cache_index=None, use_kernels=False, plans=None):
    tokens = batch["tokens"]
    dtype = getattr(torch, cfg.dtype)
    x = _embed(params, plans, tokens, cfg=cfg, policy=policy, mesh=mesh,
               dtype=dtype)
    if cfg.family == "vlm" and "patch_embeds" in batch:
        # splice precomputed patch embeddings (frontend stub) over the
        # leading n_patches token positions
        pe = batch["patch_embeds"].to(dtype) @ \
            _take(params, plans, "patch_proj")["w"].to(dtype)
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
                                  use_kernels=use_kernels,
                                  plans=_sub(plans, "layers"))
    return _head(params, plans, x, cfg=cfg, policy=policy,
                 mesh=mesh), new_cache


def forward(params: Dict[str, Any], batch: Dict[str, Any], *,
            cfg: ModelConfig, policy: MeshPolicy = MeshPolicy(),
            mesh: Any = None, cache: Optional[Any] = None,
            cache_index: Any = None, use_kernels: bool = False,
            device: Union[str, torch.device, None] = None,
            donate_cache: bool = False) -> Tuple[torch.Tensor, Any]:
    """Returns (logits, new_cache). Train/prefill: cache_index None.

    The new cache is written into a copy of ``cache``, which the caller
    keeps as it was (the reference's functional meaning).  With
    ``donate_cache`` the caller hands the cache over, as the reference's
    serving steps donate theirs (``donate_argnums``): each layer's new
    rows and states are written into its storage, and the new cache is
    that storage (a state whose new dtype is not its leaf's comes back as
    a new leaf, see ``_store``); the caller's tensors then hold the new
    cache.

    Runs on the card unless ``device="cpu"`` is asked for; the parameters
    (and the cache) must already be there, the batch's arrays (tokens,
    vlm's ``patch_embeds`` and ``positions``, encdec's ``frames``) are
    moved there.  ``use_kernels`` is the reference's ``use_pallas``:
    prefill and scoring attention run the flash-attention kernel, MoE
    experts the grouped-matmul kernel, zamba2's Mamba2 layers the SSD
    kernel and rwkv6 the WKV kernel; their plain versions on the CPU.

    On a mesh, ``params`` and ``cache`` are this rank's shards and the
    logits this rank's slice of the vocabulary (module docstring); under
    ``seq_shard`` the KV caches hold this rank's rows of the sequence
    (``models.layers.attention_block``)."""
    dev = resolve_device(device)
    where = params["embed"]["tok"].device
    if where.type != dev.type:
        raise ValueError(f"forward on {dev}: the parameters are on {where}")
    with span("lm.forward", where):
        batch = {k: v.to(where) if torch.is_tensor(v)
                 else torch.tensor(np.asarray(v), device=where)
                 for k, v in batch.items()}
        fwd = {"ssm": _rwkv_forward, "hybrid": _hybrid_forward,
               "encdec": _encdec_forward}.get(cfg.family, _decoder_forward)
        if cache is not None and not donate_cache:
            cache = tree_map(torch.clone, cache)
        plans = use_plans(cfg, policy, mesh)
        with regather_saved(plans is not None):
            return fwd(params, batch, cfg=cfg, policy=policy, mesh=mesh,
                       cache=cache, cache_index=cache_index,
                       use_kernels=use_kernels, plans=plans)


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
                  cache_index=None, use_kernels=False, plans=None):
    """The reference's ``_rwkv_forward``; its norms are ``rmsnorm`` with
    the layernorm's ``scale`` (see ``models/rwkv6.py``).  The time mix
    runs whole heads on every rank (``_whole_on_use``): where the cache
    stores the WKV state's heads split over `model`, each layer's state is
    gathered over `model` for it and this rank's heads written back."""
    from .layers import rmsnorm
    tokens = batch["tokens"]
    dtype = getattr(torch, cfg.dtype)
    x = _embed(params, plans, tokens, cfg=cfg, policy=policy, mesh=mesh,
               dtype=dtype)
    decode = cache_index is not None
    stateful = cache is not None or decode
    promoted: Dict[str, list] = {}
    layer_plans = _sub(plans, "layers")
    group, _, rank = model_part(mesh)
    heads = cache["wkv"].shape[2] if stateful else 0
    split = stateful and heads < cfg.d_model // cfg.rwkv_head_dim
    for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
        if layer_plans is not None:
            lp = gather_tree(lp, layer_plans)
        st = {key: cache[key][i] for key in ("wkv", "shift_a", "shift_f")} \
            if stateful else None
        if split:
            st["wkv"] = all_gather_dim(st["wkv"], 1, group)
        h = rmsnorm(x, lp["ln1"]["scale"], cfg.norm_eps)
        a, st_a = rwkv6_att(lp["att"], h, cfg=cfg, policy=policy, mesh=mesh,
                            state=st, decode=decode, use_kernels=use_kernels)
        x = x + a
        h2 = rmsnorm(x, lp["ln2"]["scale"], cfg.norm_eps)
        f, new_sf = rwkv6_ffn(lp["ffn"], h2, cfg=cfg, policy=policy,
                              mesh=mesh, state=st)
        x = x + f
        if stateful:
            wkv = st_a["wkv"]
            if split:
                wkv = wkv.narrow(1, rank * heads, heads)
            for key, t in (("wkv", wkv),
                           ("shift_a", st_a["shift_a"]), ("shift_f", new_sf)):
                _store(cache, key, i, t, promoted)
    new_cache = _with_promoted(cache, promoted) if stateful else None
    x = rmsnorm(x, _take(params, plans, "ln_f")["scale"], cfg.norm_eps)
    return _logits(params, plans, x, cfg=cfg, policy=policy,
                   mesh=mesh), new_cache


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
                    cache_index=None, use_kernels=False, plans=None):
    tokens = batch["tokens"]
    dtype = getattr(torch, cfg.dtype)
    x = _embed(params, plans, tokens, cfg=cfg, policy=policy, mesh=mesh,
               dtype=dtype)
    decode = cache_index is not None
    B, S = tokens.shape
    every = max(1, cfg.shared_attn_every)
    dev = tokens.device
    positions = (torch.arange(S, device=dev)[None, :] if not decode
                 else torch.zeros((B, S), dtype=torch.int32, device=dev)
                 + int(cache_index))
    positions = positions.expand(B, S)

    layer_plans = _sub(plans, "layers")

    def mamba_layer(x_in, lp, st):
        if layer_plans is not None:
            lp = gather_tree(lp, layer_plans)
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
    promoted: Dict[str, list] = {}
    layers = _unstack(params["layers"], cfg.n_layers)
    for app in range(n_apps):
        for i in range(app * every, min((app + 1) * every, cfg.n_layers)):
            lp = layers[i]
            if c is not None or decode:
                x, st = mamba_layer(x, lp, {"h": c["h"][i],
                                            "conv": c["conv"][i]})
                _store(c, "h", i, st["h"], promoted)
                _store(c, "conv", i, st["conv"], promoted)
            else:
                x, _ = mamba_layer(x, lp, None)
        # shared attention block (same params every application, gathered
        # at each)
        sp = _take(params, plans, "shared")
        hh = apply_norm(cfg, sp["ln1"], x)
        app_cache = None
        if c is not None:
            app_cache = {"k": c["shared_k"][app], "v": c["shared_v"][app]}
        a, _ = attention_block(
            sp["attn"], hh, cfg=cfg, positions=positions, policy=policy,
            mesh=mesh, is_global=True, cache=app_cache,
            cache_index=cache_index, use_kernels=use_kernels)
        x = x + a
        h2 = apply_norm(cfg, sp["ln2"], x)
        x = x + mlp_block(sp["mlp"], h2, cfg=cfg, policy=policy, mesh=mesh)
    new_cache = None if c is None else _with_promoted(c, promoted)
    return _head(params, plans, x, cfg=cfg, policy=policy,
                 mesh=mesh), new_cache


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
    ``_sdpa``, as the reference); on a mesh, this rank's heads
    (``layers._tp_heads``) and the ranks' outputs added."""
    B, Sq, d = x.shape
    dt = x.dtype
    group, p, pick = _tp_heads(p, cfg, mesh, keep_all_kv=False)
    x, enc_out = from_replicated(x, group), from_replicated(enc_out, group)
    read = pick or (lambda t: t)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", enc_out, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", enc_out, p["wv"].to(dt))
    mask = torch.ones((B, Sq, enc_out.shape[1]), dtype=torch.bool,
                      device=x.device)
    out = _sdpa(q, read(k), read(v), mask, None)
    return reduce_over(torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt)),
                       group)


def _encoder_layer(lp, x, pos, *, cfg, policy, mesh):
    """Bidirectional self-attention with RoPE (plain ``_sdpa``), then the
    MLP; the reference's encoder layer (on a mesh, as
    :func:`_cross_attention` splits its heads)."""
    h = apply_norm(cfg, lp["ln1"], x)
    B, S, _ = h.shape
    dt = h.dtype
    group, pa, pick = _tp_heads(lp["attn"], cfg, mesh, keep_all_kv=False)
    h = from_replicated(h, group)
    read = pick or (lambda t: t)
    q = torch.einsum("bsd,dhk->bshk", h, pa["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", h, pa["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", h, pa["wv"].to(dt))
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    a = _sdpa(q, read(k), read(v), torch.ones((B, S, S), dtype=torch.bool,
                                              device=h.device), None)
    a = reduce_over(torch.einsum("bshk,hkd->bsd", a, pa["wo"].to(dt)),
                    group)
    x2 = x + a
    h2 = apply_norm(cfg, lp["ln2"], x2)
    return x2 + mlp_block(lp["mlp"], h2, cfg=cfg, policy=policy, mesh=mesh)


def _encdec_forward(params, batch, *, cfg, policy, mesh, cache=None,
                    cache_index=None, use_kernels=False, plans=None):
    dtype = getattr(torch, cfg.dtype)
    decode = cache_index is not None
    # ---------------- encoder (skipped during decode: enc_out cached) ----
    if not decode:
        enc_out = batch["frames"].to(dtype)             # stub frontend
        Bf, Sf = enc_out.shape[:2]
        pos_e = torch.arange(Sf, device=enc_out.device)[None, :].expand(
            Bf, Sf)
        enc_plans = _sub(plans, "enc")
        for lp in _unstack(params["enc"], cfg.n_enc_layers):
            if enc_plans is not None:
                lp = gather_tree(lp, enc_plans)
            enc_out = _encoder_layer(lp, enc_out, pos_e, cfg=cfg,
                                     policy=policy, mesh=mesh)
        enc_out = apply_norm(cfg, _take(params, plans, "ln_enc"), enc_out)
    else:
        enc_out = cache["enc_out"].to(dtype)
    # ---------------- decoder -------------------------------------------
    tokens = batch["tokens"]
    x = _embed(params, plans, tokens, cfg=cfg, policy=policy, mesh=mesh,
               dtype=dtype)
    B, S = tokens.shape
    dev = tokens.device
    positions = (torch.arange(S, device=dev)[None, :] if not decode
                 else torch.full((B, S), int(cache_index),
                                 dtype=torch.int32, device=dev))
    positions = positions.expand(B, S)
    dec_plans = _sub(plans, "dec")
    for i, lp in enumerate(_unstack(params["dec"], cfg.n_dec_layers)):
        if dec_plans is not None:
            lp = gather_tree(lp, dec_plans)
        layer_cache = None if cache is None else \
            {"k": cache["k"][i], "v": cache["v"][i]}
        h = apply_norm(cfg, lp["ln1"], x)
        a, _ = attention_block(
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
        cache["enc_out"].copy_(enc_out)
    return _head(params, plans, x, cfg=cfg, policy=policy,
                 mesh=mesh), cache


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
    temporaries.

    Where the logits are this rank's slice of the vocabulary (a mesh that
    splits it over `model`), the max, the sum of the exponentials and the
    gold logit (this rank's where the label is among its columns, else 0)
    are each reduced over `model`; ``[B, S, V]`` is never gathered."""
    logits, _ = forward(params, batch, cfg=cfg, policy=policy, mesh=mesh,
                        use_kernels=use_kernels, device=device)
    labels = batch["labels"]
    labels = (labels if torch.is_tensor(labels) else torch.from_numpy(
        np.asarray(labels))).to(logits.device).long()
    lf = logits.float()
    V = lf.shape[-1]
    if V == cfg.vocab_size:
        m = lf.amax(-1, keepdim=True).detach()
        logz = torch.log(torch.exp(lf - m).sum(-1)) + m.squeeze(-1)
        gold = torch.gather(lf, -1,
                            labels.clamp_min(0)[..., None]).squeeze(-1)
    else:
        group, _, rank = model_part(mesh)
        with torch.no_grad():
            m = all_gather_dim(lf.amax(-1, keepdim=True), -1 % lf.dim(),
                               group).amax(-1, keepdim=True)
        total = reduce_over(torch.exp(lf - m).sum(-1), group)
        logz = torch.log(total) + m.squeeze(-1)
        ids = labels - rank * V
        held = (ids >= 0) & (ids < V)
        mine = torch.gather(lf, -1, ids.clamp(0, V - 1)[..., None])
        gold = reduce_over(torch.where(held, mine.squeeze(-1), 0.0), group)
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
