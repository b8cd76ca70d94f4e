"""Core layers: norms, RoPE / M-RoPE, GQA attention (train + KV-cache
decode, sliding-window and local:global variants), MLP variants.

The JAX package's ``repro.models.layers`` in PyTorch, with its names and
parameter layout (``wq [d, nh, hd]``, ``wo [nh, hd, d]``, ...), so its
parameters carry across as they are.

On a mesh each block computes on this rank's shards, as
``parallel.sharding.storage_pspecs`` stores them (the `data` dimension
already gathered by the caller, ``models.lm``); a block reads from its
leaves' shapes which of them split over `model`.  Attention splits its
query heads (and its kv heads where those split; else each rank takes the
kv heads its query heads read), the MLP its hidden units (column- then
row-parallel), the embedding and the head the vocabulary; the partial
sums are added by one all-reduce where the reference constrains to
``act_embed`` (``reduce_over``), and every replicated input of a split
region enters through ``from_replicated``.  Without a mesh, or where
nothing splits, the code is what it was: the same operations.  All functions are pure: the KV cache
comes back as new tensors, as in the reference.  Where the reference asks
for an fp32 result from bf16 operands (``preferred_element_type``), the
operands are upcast to fp32 first: their products are exact in fp32, so
the result is the reference's up to the order of the sums.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel.sharding import (MeshPolicy, from_replicated, model_part,
                                 reduce_over, shard_constraint)
from .config import ModelConfig
from .params import ParamSpec

# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def apply_norm(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor
               ) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rmsnorm(x, p["scale"], cfg.norm_eps)


def norm_specs(cfg: ModelConfig, d: Optional[int] = None
               ) -> Dict[str, ParamSpec]:
    d = d or cfg.d_model
    s = {"scale": ParamSpec((d,), ("embed",), "zeros")}
    if cfg.norm == "layernorm":
        s = {"scale": ParamSpec((d,), ("embed",), "ones"),
             "bias": ParamSpec((d,), ("embed",), "zeros")}
    return s


# ---------------------------------------------------------------------------
# RoPE (+ M-RoPE for qwen2-vl)
# ---------------------------------------------------------------------------


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [B, S] (int)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)    # [hd/2]
    ang = positions[..., None].float() * freqs           # [B,S,hd/2]
    return _rotate(x, ang)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: Tuple[int, ...]) -> torch.Tensor:
    """Multimodal RoPE (qwen2-vl): positions3 [B, S, 3] = (t, h, w) ids;
    the rotary half-dim is split into `sections` (t/h/w bands), each band
    rotated by its own position stream."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    bounds = torch.cumsum(torch.as_tensor(sections, device=x.device), 0)
    idx = torch.arange(hd // 2, device=x.device)
    band = torch.searchsorted(bounds, idx, right=True)
    band = band.clamp(0, positions3.shape[-1] - 1)
    pos = torch.gather(positions3.float(), -1,
                       band.expand(positions3.shape[:2] + (hd // 2,)))
    return _rotate(x, pos * freqs)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def attn_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, hd, nh, nkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    s = {
        "wq": ParamSpec((d, nh, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, nkv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, nkv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((nh, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((nh, hd), ("heads", "head_dim"), "zeros")
        s["bk"] = ParamSpec((nkv, hd), ("kv_heads", "head_dim"), "zeros")
        s["bv"] = ParamSpec((nkv, hd), ("kv_heads", "head_dim"), "zeros")
    return s


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor, softcap: Optional[float]) -> torch.Tensor:
    """q [B,Sq,H,hd], k/v [B,Sk,KV,hd] with H = KV*G. Returns [B,Sq,H,hd]."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float())
    logits = logits / math.sqrt(hd)
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    logits = torch.where(mask[:, None, None, :, :], logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(B, Sq, H, hd)


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      is_global: Any = True,
                      window: Optional[int] = None,
                      softcap: Optional[float] = None,
                      block_q: int = 512, block_k: int = 512,
                      unroll: bool = False) -> torch.Tensor:
    """Causal attention without materializing the [Sq, Sk] matrix (the
    flash-attention algorithm in plain PyTorch, as the reference's
    ``blocked_attention``): an outer loop over query blocks, an inner loop
    over key blocks with an online softmax.  Key blocks wholly masked
    (beyond the causal frontier, or outside the window of a static local
    layer) are skipped.  A ragged last block is taken as it is (the
    reference needs S a multiple of the block).  ``unroll`` is accepted
    for the reference's signature; PyTorch runs the loop eagerly."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    bq = min(block_q, S)
    bk = min(block_k, S)
    nq = -(-S // bq)
    static_local = isinstance(is_global, bool) and not is_global \
        and window is not None
    dev = q.device
    # the reference's fp32 1 / sqrt(hd)
    scale = float(1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32)))
    out_blocks = []
    for qi in range(nq):
        q0, q1 = qi * bq, min(S, (qi + 1) * bq)
        nqb = q1 - q0
        qb = q[:, q0:q1].reshape(B, nqb, KV, G, hd).float()
        lo = 0
        hi = -(-q1 // bk)                                 # causal frontier
        if static_local:
            lo = max(0, (q0 - (window - 1)) // bk)
        m = torch.full((B, KV, G, nqb), -math.inf, device=dev)
        l = torch.zeros((B, KV, G, nqb), device=dev)
        acc = torch.zeros((B, KV, G, nqb, hd), device=dev)
        qpos = torch.arange(q0, q1, device=dev)[:, None]
        for ki in range(lo, hi):
            k0, k1 = ki * bk, min(S, (ki + 1) * bk)
            kb, vb = k[:, k0:k1], v[:, k0:k1]
            s_ = torch.einsum("bqkgh,bskh->bkgqs", qb, kb.float()) * scale
            if softcap:
                s_ = softcap * torch.tanh(s_ / softcap)
            kpos = torch.arange(k0, k1, device=dev)[None, :]
            mask = kpos <= qpos
            if window is not None:
                wmask = kpos > qpos - window
                if isinstance(is_global, bool):
                    if not is_global:
                        mask = mask & wmask
                else:
                    mask = mask & torch.where(
                        torch.as_tensor(is_global, device=dev), True, wmask)
            s_ = torch.where(mask, s_, -math.inf)
            m1 = torch.maximum(m, s_.amax(-1))
            # guard fully-masked rows (m1 = -inf)
            m1s = torch.where(torch.isfinite(m1), m1, 0.0)
            p = torch.exp(s_ - m1s[..., None])
            p = torch.where(mask, p, 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m1s), 0.0)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskh->bkgqh", p.to(vb.dtype).float(), vb.float())
            m = m1
        ob = acc / torch.clamp_min(l, 1e-30)[..., None]  # [B,KV,G,bq,hd]
        out_blocks.append(ob.permute(0, 3, 1, 2, 4))     # [B,bq,KV,G,hd]
    out = torch.cat(out_blocks, dim=1)
    return out.reshape(B, S, H, hd).to(q.dtype)


def causal_mask(Sq: int, Sk: int, *, window: Optional[int] = None,
                offset: int = 0, device=None) -> torch.Tensor:
    """[1, Sq, Sk] causal (+sliding-window) mask. `offset` = absolute
    position of query 0 (for decode, offset = cache length)."""
    qpos = torch.arange(Sq, device=device)[:, None] + offset
    kpos = torch.arange(Sk, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    return m[None]


def _write_rows(cache: torch.Tensor, new: torch.Tensor, start: int
                ) -> torch.Tensor:
    """``jax.lax.dynamic_update_slice`` on axis 1: a copy of ``cache`` with
    ``new`` written from ``start`` on, the start clamped so the rows fit."""
    start = min(max(int(start), 0), cache.shape[1] - new.shape[1])
    out = cache.clone()
    out[:, start:start + new.shape[1]] = new.to(cache.dtype)
    return out


def kv_selection(n_heads: int, n_kv: int, heads_here: int, rank: int
                 ) -> Tuple[int, int, Optional[list]]:
    """The kv heads that query heads ``rank * heads_here`` on read, where
    the query heads split over `model` and the kv heads do not:
    ``(lo, hi, index)``.  The heads ``lo:hi`` are taken; ``index`` is None
    where query head ``h`` then reads kv head ``h // (heads_here /
    (hi - lo))`` (the kernels' grouping), else each query head's kv head
    in order (the kv heads repeated, one a query head)."""
    G = n_heads // n_kv
    first = rank * heads_here
    lo, hi = first // G, (first + heads_here - 1) // G + 1
    own = [(first + h) // G - lo for h in range(heads_here)]
    n = hi - lo
    if heads_here % n == 0 and all(own[h] == h // (heads_here // n)
                                   for h in range(heads_here)):
        return lo, hi, None
    return lo, hi, own


def _tp_heads(p: Dict[str, Any], cfg: ModelConfig, mesh: Any, keep_all_kv:
              bool) -> Tuple[Any, Dict[str, Any], Any]:
    """This rank's attention parameters on a mesh: ``(group, p, pick)``.
    ``group`` is the `model` group where the query heads split (else
    None: the block runs whole on every rank); ``p`` the leaves to use,
    the kv projections sliced to the heads this rank reads where they are
    replicated (whole with ``keep_all_kv``: a cache holds every kv head);
    ``pick`` maps keys or values of those leaves to the heads the
    attention reads (None: as they are)."""
    group, _, rank = model_part(mesh)
    nh = p["wq"].shape[1]
    if group is None or nh == cfg.n_heads:
        return None, p, None
    if p["wk"].shape[1] < cfg.n_kv_heads:            # kv heads split too
        return group, p, None
    lo, hi, index = kv_selection(cfg.n_heads, cfg.n_kv_heads, nh, rank)
    p = dict(p)
    for name in ("wk", "wv", "bk", "bv"):
        if name in p:
            # read inside the region: the gradient is summed over it
            w = from_replicated(p[name], group)
            axis = 1 if name[0] == "w" else 0
            p[name] = w if keep_all_kv else w.narrow(axis, lo, hi - lo)

    def pick(t: torch.Tensor) -> torch.Tensor:
        if keep_all_kv:
            t = t[:, :, lo:hi]
        return t if index is None else t[:, :, index]
    return group, p, pick


def attention_block(p: Dict[str, Any], x: torch.Tensor, *, cfg: ModelConfig,
                    positions: torch.Tensor, policy: MeshPolicy,
                    mesh: Any = None,
                    is_global: Any = True,
                    cache: Optional[Dict[str, torch.Tensor]] = None,
                    cache_index: Any = None,
                    use_kernels: bool = False
                    ) -> Tuple[torch.Tensor,
                               Optional[Dict[str, torch.Tensor]]]:
    """GQA attention. Train/prefill when `cache` is None or being filled;
    decode (Sq=1) writes `cache` at `cache_index` and attends to the whole
    cache. `is_global` may be a bool tensor (mixed local/global layers,
    gemma3): local layers apply the sliding-window mask.

    ``use_kernels`` is the reference's ``use_pallas``: prefill attention
    goes through ``kernels.flash_attention.ops.flash_attention`` (the CUDA
    kernel for CUDA tensors, its plain version for CPU tensors).  As in the
    reference, only a literal ``is_global is True`` drops the window there.

    On a mesh whose `model` axis splits the query heads, the block runs
    this rank's heads (:func:`_tp_heads`) and adds the ranks' outputs; the
    cache holds the kv heads as its axes split them.
    """
    B, Sq, d = x.shape
    dt = x.dtype
    group, p, pick = _tp_heads(p, cfg, mesh, keep_all_kv=cache is not None)
    x = from_replicated(x, group)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if cfg.mrope:
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q = shard_constraint(q, ("batch", "seq", "heads", None), policy, mesh)
    k = shard_constraint(k, ("batch", "kv_seq", "kv_heads", None), policy,
                         mesh)
    read = pick or (lambda t: t)

    window = cfg.sliding_window
    new_cache = cache
    if cache is not None and cache_index is not None:
        # decode: write k/v at cache_index, attend over the cache
        idx = int(cache_index)
        ck = _write_rows(cache["k"], k, idx)
        cv = _write_rows(cache["v"], v, idx)
        new_cache = {"k": ck, "v": cv}
        Sk = ck.shape[1]
        kpos = torch.arange(Sk, device=x.device)[None, :]
        valid = kpos <= idx                              # causal over cache
        wmask = torch.where(torch.as_tensor(is_global, device=x.device),
                            torch.ones((1, Sk), dtype=torch.bool,
                                       device=x.device),
                            kpos > idx - (window or Sk))
        mask = (valid & wmask)[:, None, :]               # [1,1,Sk]
        out = _sdpa(q, read(ck).to(q.dtype), read(cv).to(q.dtype),
                    mask.expand(B, Sq, Sk), cfg.logit_softcap)
    else:
        ka, va = read(k), read(v)
        if use_kernels:
            from ..kernels.flash_attention import ops as fa_ops
            out = fa_ops.flash_attention(
                q, ka, va, causal=True,
                window=None if (is_global is True) else window,
                softcap=cfg.logit_softcap)
        elif Sq >= 1024:
            # blocked online-softmax: never materializes [Sq,Sk] and skips
            # out-of-window blocks for static-local layers
            out = blocked_attention(q, ka, va, is_global=is_global,
                                    window=window,
                                    softcap=cfg.logit_softcap,
                                    block_q=cfg.attn_block_q,
                                    block_k=cfg.attn_block_k,
                                    unroll=cfg.unroll_scans)
        else:
            full = causal_mask(Sq, Sq, device=x.device)
            local = causal_mask(Sq, Sq, window=window, device=x.device)
            mask = torch.where(torch.as_tensor(is_global, device=x.device),
                               full, local)
            out = _sdpa(q, ka, va, mask.expand(B, Sq, Sq),
                        cfg.logit_softcap)
        del ka, va
        if cache is not None:                            # prefill fills cache
            ck = torch.zeros_like(cache["k"])
            cv = torch.zeros_like(cache["v"])
            ck[:, :Sq] = k
            cv[:, :Sq] = v
            new_cache = {"k": ck, "v": cv}
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(out.dtype))
    y = reduce_over(y, group)
    y = shard_constraint(y, ("batch", "seq", "act_embed"), policy, mesh)
    return y, new_cache


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------


def mlp_specs(cfg: ModelConfig, d_ff: Optional[int] = None
              ) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp_type == "swiglu":
        return {"wi": ParamSpec((d, f), ("embed", "mlp")),
                "wg": ParamSpec((d, f), ("embed", "mlp")),
                "wo": ParamSpec((f, d), ("mlp", "embed"))}
    return {"wi": ParamSpec((d, f), ("embed", "mlp")),
            "wo": ParamSpec((f, d), ("mlp", "embed"))}


def mlp_block(p: Dict[str, Any], x: torch.Tensor, *, cfg: ModelConfig,
              policy: MeshPolicy, mesh: Any = None) -> torch.Tensor:
    """On a mesh that splits the hidden units (``wi``'s columns) over
    `model`: column-parallel in, row-parallel out, the ranks' outputs
    added."""
    dt = x.dtype
    group = model_part(mesh)[0] if p["wi"].shape[-1] < cfg.d_ff else None
    x = from_replicated(x, group)
    if cfg.mlp_type == "swiglu":
        h = F.silu(x @ p["wg"].to(dt)) * (x @ p["wi"].to(dt))
    elif cfg.mlp_type == "relu2":                     # nemotron squared-ReLU
        h = torch.square(F.relu(x @ p["wi"].to(dt)))
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ p["wi"].to(dt), approximate="tanh")
    h = shard_constraint(h, ("batch", "seq", "mlp"), policy, mesh)
    y = reduce_over(h @ p["wo"].to(dt), group)
    return shard_constraint(y, ("batch", "seq", "act_embed"), policy, mesh)


# ---------------------------------------------------------------------------
# embeddings / head
# ---------------------------------------------------------------------------


def embed_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    s = {"tok": ParamSpec((cfg.vocab_size, cfg.d_model),
                          ("vocab", "embed"), "normal", 1.0)}
    if not cfg.tie_embeddings:
        s["head"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                              ("embed", "vocab"))
    return s


def embed(p: Dict[str, Any], tokens: torch.Tensor, *, policy: MeshPolicy,
          mesh: Any = None, dtype: torch.dtype = torch.bfloat16,
          vocab_size: Optional[int] = None) -> torch.Tensor:
    """Token embeddings.  Where the table holds fewer rows than
    ``vocab_size`` (its vocabulary split over `model`), each rank looks up
    the tokens of its rows, the others as zeros, and the ranks' rows are
    added."""
    tok = p["tok"]
    V = tok.shape[0]
    if vocab_size is None or V == vocab_size:
        # gather then cast: the same values as casting the table first
        x = tok[tokens.long()].to(dtype)
    else:
        group, _, rank = model_part(mesh)
        ids = tokens.long() - rank * V
        held = (ids >= 0) & (ids < V)
        x = torch.where(held[..., None], tok[ids.clamp(0, V - 1)],
                        torch.zeros((), dtype=tok.dtype, device=tok.device))
        x = reduce_over(x.to(dtype), group)
    return shard_constraint(x, ("batch", "seq", "act_embed"), policy, mesh)


def lm_head(p: Dict[str, Any], x: torch.Tensor, *, policy: MeshPolicy,
            mesh: Any = None, vocab_size: Optional[int] = None
            ) -> torch.Tensor:
    """fp32 logits; where the head holds fewer columns than
    ``vocab_size``, this rank's slice of the vocabulary (the reference's
    ``("batch", "seq", "vocab")`` layout)."""
    w = p.get("head")
    if w is None:
        w = p["tok"].t()
    if vocab_size is not None and w.shape[1] < vocab_size:
        x = from_replicated(x, model_part(mesh)[0])
    # the reference's bf16 operands with an fp32 result
    logits = x.float() @ w.to(x.dtype).float()
    return shard_constraint(logits, ("batch", "seq", "vocab"), policy, mesh)
