"""What the plain PyTorch forwards of the families (``families/``) share,
written from the layer equations: fp32 throughout, one matrix product
per projection, causal attention in its direct form.  No kernel, no
cache, no batching tricks; nothing of the program is imported.

Every product goes through a ``mm`` argument: :func:`mm32` (fp32; the
caller turns TF32 off, see :func:`fp32_exact`) or :func:`mm8`, the same
products with both operands rounded to float8 (e4m3, one scale a
tensor; the backward's incoming gradient to e5m2): the control, a model
computed one precision below the bf16 the configurations state.

Where the program's model departs from the published one, the reference
follows the program (the departures are listed in each configuration's
file, ``departures``).
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Dict, Tuple

import torch

from perfbench.reference import families

Tensor = torch.Tensor
MM = Callable[[Tensor, Tensor], Tensor]


@contextlib.contextmanager
def fp32_exact():
    """fp32 products as fp32 (no TF32) inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _flat(a: Tensor, b: Tensor) -> Tuple[Tensor, Tuple[int, ...]]:
    """``a`` as a matrix where ``b`` is one (a weight), else as it is."""
    if b.dim() == 2 and a.dim() > 2:
        return a.reshape(-1, a.shape[-1]), a.shape[:-1]
    return a, ()


def mm32(a: Tensor, b: Tensor) -> Tensor:
    x, lead = _flat(a, b)
    y = torch.matmul(x, b)
    return y.reshape(*lead, b.shape[-1]) if lead else y


E4M3, E5M2 = torch.float8_e4m3fn, torch.float8_e5m2
_FMAX = {E4M3: 448.0, E5M2: 57344.0}


def quant(x: Tensor, dtype: torch.dtype = E4M3) -> Tensor:
    """``x`` rounded to ``dtype`` with one scale for the tensor, back in
    fp32."""
    s = x.detach().abs().amax().float().clamp_min(1e-30) / _FMAX[dtype]
    return (x / s).to(dtype).to(torch.float32) * s


class _MM8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        aq, bq = quant(a), quant(b)
        ctx.save_for_backward(aq, bq)
        return torch.matmul(aq, bq)

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        gq = quant(g, E5M2)
        return (torch.matmul(gq, bq.transpose(-1, -2)),
                torch.matmul(aq.transpose(-1, -2), gq))


def mm8(a: Tensor, b: Tensor) -> Tensor:
    x, lead = _flat(a, b)
    y = _MM8.apply(x, b)
    return y.reshape(*lead, b.shape[-1]) if lead else y


def rmsnorm(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * \
        (1.0 + scale)


def rope(x: Tensor, theta: float) -> Tensor:
    """x [B, S, H, hd] at positions 0..S-1, the two halves rotated."""
    S, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = ang.cos()[None, :, None], ang.sin()[None, :, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def causal_attention(q: Tensor, k: Tensor, v: Tensor, mm: MM) -> Tensor:
    """q [B,S,H,hd], k/v [B,S,KV,hd] (query head h reads kv head
    h // (H / KV)) -> [B,S,H,hd]."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    qh = q.transpose(1, 2)
    kh = k.transpose(1, 2).repeat_interleave(G, dim=1)
    vh = v.transpose(1, 2).repeat_interleave(G, dim=1)
    s = mm(qh, kh.transpose(-1, -2)) / math.sqrt(hd)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, -math.inf), dim=-1)
    return mm(p, vh).transpose(1, 2)


def layer_slice(p: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i``'s slice of a stacked subtree."""
    return {k: (layer_slice(v, i) if isinstance(v, dict) else v[i])
            for k, v in p.items()}


def forward(p: Dict[str, Any], tokens: Tensor, m: Dict[str, Any],
            mm: MM = mm32) -> Tensor:
    """fp32 logits [B, S, V] of the model's family
    (``families/<model["reference"]>.py``)."""
    return families.load(m).forward(p, tokens, m, mm=mm)
