"""Mamba2 (state-space dual / SSD) mixer — the zamba2 backbone block.

The JAX package's ``repro.models.mamba2`` in PyTorch.  Chunked SSD
algorithm (also the plain version of the ``kernels/mamba2_ssd`` CUDA
kernel): within a chunk of length Q the output is an attention-like
quadratic form masked by cumulative decays; across chunks a recurrent state
``h [B, H, hd, N]`` carries the summary.  Decode is a single-step state
update.

On a mesh the block runs whole on every rank: ``models.lm`` gathers its
``norm`` and ``out_proj`` (split over `model` in the reference's layout)
before it runs.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel.sharding import MeshPolicy, shard_constraint
from .config import ModelConfig
from .params import ParamSpec


def mamba2_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    H = cfg.ssm_heads or max(1, d_in // 64)
    N = cfg.ssm_state
    return {
        "in_proj": ParamSpec((d, 2 * d_in + 2 * N + H), ("embed", None)),
        "conv": ParamSpec((cfg.ssm_conv, d_in + 2 * N), ("conv", None)),
        "A_log": ParamSpec((H,), (None,), "ones"),
        "D": ParamSpec((H,), (None,), "ones"),
        "dt_bias": ParamSpec((H,), (None,), "zeros"),
        "norm": ParamSpec((d_in,), ("mlp",), "zeros"),
        "out_proj": ParamSpec((d_in, d), ("mlp", "embed")),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor
                ) -> Tuple[torch.Tensor, ...]:
    d_in = cfg.ssm_expand * cfg.d_model
    H = cfg.ssm_heads or max(1, d_in // 64)
    N = cfg.ssm_state
    z, x, Bc, Cc, dt = torch.split(zxbcdt, [d_in, d_in, N, N, H], dim=-1)
    return z, x, Bc, Cc, dt


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): no linear threshold, as
    ``torch.nn.functional.softplus`` has above 20."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x [B,S,D]; w [K,D]. Returns (y, new_state)
    where state is the last K-1 inputs (decode carry)."""
    K = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    S = x.shape[1]
    y = sum(xp[:, i:i + S, :] * w[i] for i in range(K))
    return F.silu(y), xp[:, -(K - 1):, :]


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bc: torch.Tensor, Cc: torch.Tensor, *, chunk: int = 128,
                h0: Optional[torch.Tensor] = None, unroll: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan. x [B,S,H,hd]; dt [B,S,H] (softplus'd); A [H] (negative);
    Bc/Cc [B,S,N]. Returns (y [B,S,H,hd], h [B,H,hd,N]).  Chunks as the
    reference cuts them: ``nc = max(1, S // chunk)`` chunks of ``S // nc``
    steps (S must be a multiple of that).  ``unroll`` is accepted for the
    reference's signature."""
    B, S, H, hd = x.shape
    N = Bc.shape[-1]
    nc = max(1, S // chunk)
    Q = S // nc
    xr = x.reshape(B, nc, Q, H, hd)
    dtr = dt.reshape(B, nc, Q, H)
    Br = Bc.reshape(B, nc, Q, N)
    Cr = Cc.reshape(B, nc, Q, N)
    if h0 is None:
        h0 = torch.zeros((B, H, hd, N), dtype=torch.float32, device=x.device)
    h = h0.float()

    la = dtr * A[None, None, None, :]                  # log decay per step
    cum = torch.cumsum(la, dim=2)                      # [B,nc,Q,H]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    ys = []
    for c in range(nc):
        xq, dtq = xr[:, c], dtr[:, c]
        bq, cq, cumq = Br[:, c], Cr[:, c], cum[:, c]
        # intra-chunk quadratic form: M[t,s] = C_t.B_s * exp(cum_t - cum_s)
        # * dt_s   for s <= t
        cb = torch.einsum("bqn,bsn->bqs", cq.float(), bq.float())
        seg = cumq[:, :, None, :] - cumq[:, None, :, :]     # [B,Q,S,H]
        # mask BEFORE exp: discarded (future) entries would overflow
        seg = torch.where(tri[None, :, :, None], seg, -torch.inf)
        decay = torch.exp(seg)
        M = cb[..., None] * decay * dtq[:, None, :, :]      # [B,Q,S,H]
        y_intra = torch.einsum("bqsh,bshp->bqhp", M, xq.float())
        # inter-chunk: contribution of carried state
        state_decay = torch.exp(cumq)                        # [B,Q,H]
        y_state = torch.einsum("bqn,bhpn,bqh->bqhp", cq.float(), h,
                               state_decay)
        # state update
        rem = torch.exp(cumq[:, -1:, :] - cumq)              # [B,Q,H]
        dx = xq.float() * (dtq * rem)[..., None]
        h = h * torch.exp(cumq[:, -1, :])[:, :, None, None] + \
            torch.einsum("bqhp,bqn->bhpn", dx, bq.float())
        ys.append((y_intra + y_state).to(x.dtype))
    y = torch.stack(ys, dim=1).reshape(B, S, H, hd)
    return y, h


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    Bc: torch.Tensor, Cc: torch.Tensor, h: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token state update. x [B,1,H,hd]; h [B,H,hd,N]."""
    a = torch.exp(dt[:, 0, :] * A[None, :])            # [B,H]
    hf = h * a[:, :, None, None] + torch.einsum(
        "bhp,bn,bh->bhpn", x[:, 0].float(), Bc[:, 0].float(), dt[:, 0])
    y = torch.einsum("bn,bhpn->bhp", Cc[:, 0].float(), hf)
    return y[:, None].to(x.dtype), hf


def mamba2_block(p: Dict[str, Any], x: torch.Tensor, *, cfg: ModelConfig,
                 policy: MeshPolicy, mesh: Any = None,
                 state: Optional[Dict[str, torch.Tensor]] = None,
                 decode: bool = False, use_kernels: bool = False
                 ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Full mixer: in_proj -> causal conv -> SSD -> gated RMSNorm ->
    out_proj. `state` = {"h": [B,H,hd,N], "conv": [B,K-1,D]} for decode.

    ``use_kernels`` is the reference's ``use_pallas``: the scan goes through
    ``kernels.mamba2_ssd.ops.ssd`` (the CUDA kernel for CUDA tensors, with
    a carried state too; the plain version for CPU tensors)."""
    B, S, d = x.shape
    d_in = cfg.ssm_expand * d
    H = cfg.ssm_heads or max(1, d_in // 64)
    hd = d_in // H
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xi, Bc, Cc, dt = _split_proj(cfg, zxbcdt)
    conv_in = torch.cat([xi, Bc, Cc], dim=-1)
    conv_state = state["conv"] if state is not None else None
    conv_out, new_conv = _causal_conv(conv_in, p["conv"].to(x.dtype),
                                      conv_state)
    xi, Bc, Cc = torch.split(conv_out, [d_in, cfg.ssm_state, cfg.ssm_state],
                             dim=-1)
    dtp = softplus(dt + p["dt_bias"]).float()
    A = -torch.exp(p["A_log"].float())
    xh = xi.reshape(B, S, H, hd)
    h0 = state["h"] if state is not None else None
    if decode:
        y, h = ssd_decode_step(
            xh, dtp, A, Bc, Cc,
            h0 if h0 is not None else torch.zeros(
                (B, H, hd, cfg.ssm_state), dtype=torch.float32,
                device=x.device))
    elif use_kernels:
        from ..kernels.mamba2_ssd import ops as ssd_ops
        y, h = ssd_ops.ssd(xh, dtp, A, Bc, Cc, h0=h0)
    else:
        y, h = ssd_chunked(xh, dtp, A, Bc, Cc, h0=h0,
                           unroll=cfg.unroll_scans)
    y = y + xh.to(y.dtype) * p["D"][None, None, :, None].to(y.dtype)
    y = y.reshape(B, S, d_in)
    from .layers import rmsnorm
    y = rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"].to(y.dtype)
    out = shard_constraint(out, ("batch", "seq", "act_embed"), policy, mesh)
    new_state = {"h": h, "conv": new_conv} if (state is not None or decode) \
        else None
    return out, new_state
