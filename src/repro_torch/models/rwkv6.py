"""RWKV-6 "Finch" block (attention-free; data-dependent decay).

The JAX package's ``repro.models.rwkv6`` in PyTorch.  Recurrence (per
head; k, r, w in R^hd, v in R^hd):

    y_t = r_t · S_{t-1} + (r_t ⊙ u ⊙ k_t) · 1 * v_t
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

with w_t = exp(-exp(w0 + LoRA(x_t))) data-dependent per channel.  The
chunked form (also the plain version of the ``kernels/rwkv6_scan`` CUDA
kernel) rewrites the intra-chunk part as a [Q,Q] quadratic form over
decay-normalized keys/receptances and carries S across chunks.  Decode is
a single-step state update.

The reference's quirks are kept, for parity:

- the block norms ``ln1``/``ln2`` (and ``ln_f``) are applied by the model
  with ``rmsnorm(x, scale)``, although ``norm="layernorm"`` makes their
  ``scale`` start at ones (so the factor ``1 + scale`` is 2);
- ``ln_x`` is an rmsnorm over all of d, not a group norm per head;
- the plain path cuts chunks of 64 steps, the kernel path chunks of 32.

On a mesh the time-mix leaves (``heads_flat``) arrive whole (``models.lm``
gathers them over `model`: a 64-wide head would be cut in two), so the
time mixing runs whole on every rank; the channel mix splits its hidden
units.

Unlike the reference, :func:`wkv6_chunked` takes any S: chunks of
``chunk`` steps, the last one cut short (the reference reshapes into
``S // chunk`` chunks of ``S // nc`` steps, which fails where that does not
divide S).  Where the reference is defined it computes the same function.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel.sharding import (MeshPolicy, from_replicated, model_part,
                                 reduce_over, shard_constraint)
from .config import ModelConfig
from .params import ParamSpec


def rwkv6_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d, f = cfg.d_model, cfg.d_ff
    lora = 64
    return {
        "att": {
            "mu": ParamSpec((5, d), (None, "embed"), "zeros"),   # r,k,v,w,g
            "wr": ParamSpec((d, d), ("embed", "heads_flat")),
            "wk": ParamSpec((d, d), ("embed", "heads_flat")),
            "wv": ParamSpec((d, d), ("embed", "heads_flat")),
            "wg": ParamSpec((d, d), ("embed", "heads_flat")),
            "wo": ParamSpec((d, d), ("heads_flat", "embed")),
            "w0": ParamSpec((d,), ("heads_flat",), "zeros"),
            "w_lora_a": ParamSpec((d, lora), ("embed", None)),
            "w_lora_b": ParamSpec((lora, d), (None, "heads_flat")),
            "u": ParamSpec((d,), ("heads_flat",), "zeros"),
            "ln_x": ParamSpec((d,), ("heads_flat",), "zeros"),
        },
        "ffn": {
            "mu": ParamSpec((2, d), (None, "embed"), "zeros"),   # k,r
            "wk": ParamSpec((d, f), ("embed", "mlp")),
            "wv": ParamSpec((f, d), ("mlp", "embed")),
            "wr": ParamSpec((d, d), ("embed", None)),
        },
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_{t-1} stream; `prev` is the last token of the previous segment
    (decode carry).  Returns (shifted, new_prev).  ``torch.cat`` promotes a
    bf16 carry beside fp32 activations as ``jnp.concatenate`` does."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    shifted = torch.cat([prev, x[:, :-1]], dim=1)
    return shifted, x[:, -1:]


def wkv6_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor, *, chunk: int = 64,
                 s0: Optional[torch.Tensor] = None, unroll: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/w: [B,S,H,hd] (w = per-step decay in (0,1)); u: [H,hd];
    s0 [B,H,hd,hd] (any float dtype, computed in fp32).  Returns
    (y [B,S,H,hd] in r's dtype, S [B,H,hd,hd] fp32).  ``unroll`` is
    accepted for the reference's signature."""
    B, S, H, hd = r.shape
    Q = max(1, min(chunk, S))
    # the reference's clamp: strong data-dependent decay underflows w to 0
    # in fp32; -60 per step keeps every chunk-cumulative exponent finite
    # while exp() underflows cleanly
    lw_all = torch.clamp_min(torch.log(torch.clamp_min(w.float(), 1e-30)),
                             -60.0)
    s = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    uf = u.float()
    ys = []
    for c0 in range(0, S, Q):
        rq, kq, vq = (t[:, c0:c0 + Q].float() for t in (r, k, v))
        lwq = lw_all[:, c0:c0 + Q]
        L = rq.shape[1]
        cum = torch.cumsum(lwq, dim=1)                 # [B,L,H,hd]
        # intra-chunk: y_t += sum_{s<t} (r_t . prod_{j=s+1..t-1} w_j . k_s)
        # v_s.  The pairwise exponent cum_{t-1} - cum_s is <= 0 for every
        # VALID (s < t) pair, so masking BEFORE exponentiation is safe for
        # arbitrary data-dependent decays
        cum_prev = cum - lwq                           # cum_{t-1}
        seg = cum_prev[:, :, None] - cum[:, None]      # [B,L,L,H,hd]
        tri = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                    device=r.device), diagonal=-1)
        seg = torch.where(tri[None, :, :, None, None], seg, -torch.inf)
        att = (rq[:, :, None] * kq[:, None] * torch.exp(seg)).sum(-1)
        att = att.permute(0, 3, 1, 2)                  # [B,H,L(q),L(s)]
        # carried-state receptance (exponent cum_{t-1} <= 0: safe)
        r_n = rq * torch.exp(cum_prev)
        # diagonal (s == t) uses the bonus u
        diag = (rq * uf[None, None] * kq).sum(-1)      # [B,L,H]
        y = torch.einsum("bhqs,bshd->bqhd", att, vq)
        y = y + diag[..., None] * vq
        y = y + torch.einsum("bqhc,bhcd->bqhd", r_n, s)
        # state update: S' = diag(prod w) S + sum_s (k_s e^{cum_L - cum_s})
        # v_s
        k_end = kq * torch.exp(cum[:, -1:] - cum)
        s = s * torch.exp(cum[:, -1])[..., None] + \
            torch.einsum("bshc,bshd->bhcd", k_end, vq)
        ys.append(y)
    y = torch.cat(ys, dim=1) if ys else r.float()
    return y.to(r.dtype), s


def wkv6_step(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, s: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step.  r/k/v/w: [B,1,H,hd]; s: [B,H,hd,hd] (a bf16
    cache is promoted, as JAX promotes it: the new state is fp32)."""
    rf, kf, vf = (a[:, 0].float() for a in (r, k, v))
    wf = w[:, 0].float()
    sf = s.float()
    y = torch.einsum("bhc,bhcd->bhd", rf, sf) + \
        ((rf * u.float()[None]) * kf).sum(-1, keepdim=True) * vf
    s_new = sf * wf[..., None] + kf[..., :, None] * vf[..., None, :]
    return y[:, None].to(r.dtype), s_new


def rwkv6_att(p: Dict[str, Any], x: torch.Tensor, *, cfg: ModelConfig,
              policy: MeshPolicy, mesh: Any = None,
              state: Optional[Dict[str, torch.Tensor]] = None,
              decode: bool = False, use_kernels: bool = False
              ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Time mixing.  ``use_kernels`` is the reference's ``use_pallas``:
    the scan goes through ``kernels.rwkv6_scan.ops.wkv6`` (the CUDA kernel
    for CUDA tensors, with a carried state too; the plain version with
    chunks of 32 for CPU tensors)."""
    B, S, d = x.shape
    hd = cfg.rwkv_head_dim
    H = d // hd
    prev = state["shift_a"] if state is not None else None
    xs, new_prev = _token_shift(x, prev)
    dt = x.dtype
    mu = p["mu"].to(dt)                                  # [5, d]
    mix = [x + (xs - x) * mu[i] for i in range(5)]
    r = (mix[0] @ p["wr"].to(dt)).reshape(B, S, H, hd)
    k = (mix[1] @ p["wk"].to(dt)).reshape(B, S, H, hd)
    v = (mix[2] @ p["wv"].to(dt)).reshape(B, S, H, hd)
    g = F.silu(mix[4] @ p["wg"].to(dt))
    wlog = p["w0"].float() + \
        ((mix[3] @ p["w_lora_a"].to(dt)) @ p["w_lora_b"].to(dt)).float()
    w = torch.exp(-torch.exp(wlog)).reshape(B, S, H, hd)
    u = p["u"].float().reshape(H, hd)
    s0 = state["wkv"] if state is not None else None
    if decode:
        y, s = wkv6_step(r, k, v, w, u,
                         s0 if s0 is not None else torch.zeros(
                             (B, H, hd, hd), dtype=torch.float32,
                             device=x.device))
    elif use_kernels:
        from ..kernels.rwkv6_scan import ops as wkv_ops
        y, s = wkv_ops.wkv6(r, k, v, w, u, s0=s0)
    else:
        y, s = wkv6_chunked(r, k, v, w, u, s0=s0, unroll=cfg.unroll_scans)
    from .layers import rmsnorm
    y = rmsnorm(y.reshape(B, S, d), p["ln_x"], cfg.norm_eps) * g
    out = y.to(dt) @ p["wo"].to(dt)
    out = shard_constraint(out, ("batch", "seq", "act_embed"), policy, mesh)
    new_state = None
    if state is not None or decode:
        new_state = {"wkv": s, "shift_a": new_prev}
    return out, new_state


def rwkv6_ffn(p: Dict[str, Any], x: torch.Tensor, *, cfg: ModelConfig,
              policy: MeshPolicy, mesh: Any = None,
              state: Optional[Dict[str, torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Channel mixing.  Returns (out, the new ``shift_f`` carry).  On a
    mesh that splits its hidden units over `model`, ``wk`` is
    column-parallel and ``wv`` row-parallel (``layers.mlp_block``'s
    split), the gate ``wr`` whole."""
    prev = state["shift_f"] if state is not None else None
    xs, new_prev = _token_shift(x, prev)
    dt = x.dtype
    mu = p["mu"].to(dt)
    xk = x + (xs - x) * mu[0]
    xr = x + (xs - x) * mu[1]
    group = model_part(mesh)[0] if p["wk"].shape[-1] < cfg.d_ff else None
    xk = from_replicated(xk, group)
    kk = torch.square(torch.relu(xk @ p["wk"].to(dt)))
    kk = shard_constraint(kk, ("batch", "seq", "mlp"), policy, mesh)
    y = reduce_over(kk @ p["wv"].to(dt), group) * \
        torch.sigmoid(xr @ p["wr"].to(dt))
    return shard_constraint(y, ("batch", "seq", "act_embed"), policy,
                            mesh), new_prev
