"""Flash attention with a recompute-based backward.

:func:`flash_attention` runs the CUDA kernel for CUDA tensors and the plain
version (``ref.attention_ref``) for CPU tensors.  Its backward recomputes
attention through the plain version's autograd, the recipe of the JAX
package's ``custom_vjp`` (``repro/kernels/flash_attention/ops.py``): only
q, k and v are saved.  The JAX package has no backward kernel, its VJP of
the jnp oracle runs outside any Pallas kernel, so this is its backward,
not a fallback.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import kernel, ref


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap)
        if q.is_cuda:
            return kernel.flash_attention_fwd(
                q.contiguous(), k.contiguous(), v.contiguous(),
                causal=causal, window=window, softcap=softcap)
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 softcap=softcap)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = ref.attention_ref(q, k, v, **ctx.opts)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """q [B,S,H,hd]; k/v [B,S,KV,hd] -> [B,S,H,hd]."""
    return _FlashAttention.apply(q, k, v, causal, window, softcap)
