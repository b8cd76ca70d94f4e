"""Plain PyTorch version of the flash-attention kernel (exact softmax), as
the JAX package's ``attention_ref``; any device."""
from __future__ import annotations

import math
from typing import Optional

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None) -> torch.Tensor:
    """q [B,S,H,hd]; k/v [B,S,KV,hd] (GQA) -> [B,S,H,hd]."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd).float()
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float())
    logits = logits / math.sqrt(hd)
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)
