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
nothing splits, the code is what it was: the same operations.  All
functions are pure but one: :func:`attention_block` writes the new rows
into the KV cache it is given and returns that cache (``models.lm.
forward`` hands it a copy unless the caller donates the cache, as the
reference's serving steps donate theirs).  Under ``seq_shard`` the cache
holds this rank's rows of the sequence only (``parallel.sharding.
seq_part``): a decode writes the new row where it falls and combines the
ranks' partial softmaxes (:func:`_sdpa_over_shards`).  Where the
reference asks for an fp32 result from bf16 operands
(``preferred_element_type``), the operands are upcast to fp32 first:
their products are exact in fp32, so the result is the reference's up
to the order of the sums.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel.sharding import (MeshPolicy, all_gather_list,
                                 from_replicated, model_part, reduce_over,
                                 seq_part, shard_constraint)
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


def _write_rows(cache: torch.Tensor, new: torch.Tensor, start: int,
                first: int = 0, total: Optional[int] = None) -> None:
    """``jax.lax.dynamic_update_slice`` on axis 1, in place: ``new``
    written from global row ``start`` on, the start clamped so that the
    rows fit in ``total`` rows (the whole cache's length; ``cache``'s own
    by default).  ``cache`` holds the global rows ``first .. first +
    cache.shape[1]`` (a sequence shard): only the rows of ``new`` that
    fall there are written."""
    n = new.shape[1]
    total = cache.shape[1] if total is None else total
    start = min(max(int(start), 0), total - n)
    lo = max(start, first)
    hi = min(start + n, first + cache.shape[1])
    if lo < hi:
        cache[:, lo - first:hi - first].copy_(new[:, lo - start:hi - start])


def _partial_softmax(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor, softcap: Optional[float]
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`_sdpa`'s softmax over these keys only, unnormalised, fp32:
    ``(m, l, o)``, the logits' max ``[B, KV, G, Sq]``, the sum of their
    exponentials about it and the weighted values ``[B, KV, G, Sq, hd]``.
    The logits are scaled, capped and filled with ``-1e30`` where masked
    as :func:`_sdpa` does, so a shard with no valid key has a finite
    ``m`` of -1e30 and gets no weight beside one that has."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float())
    logits = logits / math.sqrt(hd)
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    logits = torch.where(mask[:, None, None, :, :], logits, -1e30)
    m = logits.amax(-1)
    p = torch.exp(logits - m[..., None])
    return m, p.sum(-1), torch.einsum("bkgqs,bskh->bkgqh", p, v.float())


def _combine_partials(parts: list) -> torch.Tensor:
    """Partial softmaxes over disjoint sets of keys, each ``(m, l, o)``
    of :func:`_partial_softmax` packed along the last axis ``[B, KV, G,
    Sq, hd + 2]``, combined in list order: ``M = max m_r``, ``w_r =
    exp(m_r - M)``, ``O = sum w_r o_r / sum w_r l_r`` (fp32, ``[B, KV, G,
    Sq, hd]``).  A part whose keys were all masked (``m_r = -1e30``) gets
    weight 0 beside one with a valid key; where none has one, every part
    weighs 1, as :func:`_sdpa`'s softmax over a row of fills does."""
    top = parts[0][..., 0]
    for t in parts[1:]:
        top = torch.maximum(top, t[..., 0])
    num = den = None
    for t in parts:
        w = torch.exp(t[..., 0] - top)
        wo, wl = w[..., None] * t[..., 2:], w * t[..., 1]
        num = wo if num is None else num + wo
        den = wl if den is None else den + wl
    return num / den[..., None]


def _sdpa_over_shards(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mask: torch.Tensor, softcap: Optional[float],
                      group: Any) -> torch.Tensor:
    """:func:`_sdpa` over keys split along the sequence over ``group``
    (``k``/``v``/``mask`` this rank's rows): each rank's
    :func:`_partial_softmax`, one all-gather of the packed ``(m, l, o)``,
    and on every rank :func:`_combine_partials` in rank order, cast to
    ``v``'s dtype.  Every rank combines the same gathered values in the
    same order, so every rank's output is bitwise alike (the batch is
    replicated over the group in these cells)."""
    B, Sq, H, hd = q.shape
    m, l, o = _partial_softmax(q, k, v, mask, softcap)
    packed = torch.cat([m[..., None], l[..., None], o], -1)
    out = _combine_partials(all_gather_list(packed, group))
    out = out.permute(0, 3, 1, 2, 4)                      # [B,Sq,KV,G,hd]
    return out.reshape(B, Sq, H, hd).to(v.dtype)


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

    The new rows are written into ``cache`` itself (``copy_``, the
    reference's ``dynamic_update_slice`` and clamp on the global index),
    which comes back as the new cache; a prefill writes rows ``[0, Sq)``
    and zeros after them (the reference's pad).  Where the policy splits
    the cache's sequence over a mesh axis (:func:`~repro_torch.parallel.
    sharding.seq_part`), this rank holds the rows ``[r * S_loc, (r + 1)
    * S_loc)``:
    a row is written by the rank that holds it, the masks read global
    positions, and the decode's softmax is combined across the ranks
    (:func:`_sdpa_over_shards`; no autograd through that gather).

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
    # this rank's rows of the cache: all of them unless its sequence is
    # split over a mesh axis (seq_shard)
    seq_group, n_seq, seq_rank = seq_part(policy, mesh)
    if cache is not None and cache_index is not None:
        # decode: write k/v at cache_index, attend over the cache
        idx = int(cache_index)
        ck, cv = cache["k"], cache["v"]
        S_loc = ck.shape[1]
        first, Sk = seq_rank * S_loc, S_loc * n_seq
        _write_rows(ck, k, idx, first, Sk)
        _write_rows(cv, v, idx, first, Sk)
        kpos = torch.arange(first, first + S_loc, device=x.device)[None, :]
        valid = kpos <= idx                              # causal over cache
        wmask = torch.where(torch.as_tensor(is_global, device=x.device),
                            torch.ones((1, S_loc), dtype=torch.bool,
                                       device=x.device),
                            kpos > idx - (window or Sk))
        mask = (valid & wmask)[:, None, :].expand(B, Sq, S_loc)
        kk, vv = read(ck).to(q.dtype), read(cv).to(q.dtype)
        if seq_group is None:
            out = _sdpa(q, kk, vv, mask, cfg.logit_softcap)
        else:
            out = _sdpa_over_shards(q, kk, vv, mask, cfg.logit_softcap,
                                    seq_group)
        del kk, vv
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
            S_loc = cache["k"].shape[1]
            first = seq_rank * S_loc
            for name, new in (("k", k), ("v", v)):
                _write_rows(cache[name], new, 0, first, S_loc * n_seq)
                # the reference pads with zeros: the rows from Sq on
                cache[name][:, max(0, Sq - first):].zero_()
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(out.dtype))
    y = reduce_over(y, group)
    y = shard_constraint(y, ("batch", "seq", "act_embed"), policy, mesh)
    return y, cache


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
