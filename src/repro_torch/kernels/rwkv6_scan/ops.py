"""The WKV scan: the CUDA kernel for CUDA tensors, the plain version for
CPU tensors, with the reference's oracle backward.

The JAX package's ``ops.wkv6`` sends a carried state ``s0`` to its jnp
reference; here the kernel takes the initial state itself, so on the card
the cache-filling prefill launches the kernel too and no plain version
runs.  The function computed is the one ``ref.wkv6_ref(..., s0=s0)``
computes.  The backward differentiates the plain version, as the
reference's ``custom_vjp`` does (``repro/kernels/rwkv6_scan/ops.py``):
the JAX package has no backward kernel, its VJP of the jnp oracle runs
outside any Pallas kernel, so this is its backward, not a fallback.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import kernel, ref


class _WKV6(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, w, u, s0, chunk):
        ctx.save_for_backward(r, k, v, w, u, s0)
        ctx.chunk = chunk
        if r.is_cuda:
            return kernel.wkv6_fwd(
                r.contiguous(), k.contiguous(), v.contiguous(),
                w.float().contiguous(), u.float().contiguous(),
                s0=None if s0 is None else s0.contiguous(), chunk=chunk)
        return ref.wkv6_ref(r, k, v, w, u, s0=s0, chunk=chunk)

    @staticmethod
    def backward(ctx, gy, gs):
        ins = [None if t is None else t.detach().requires_grad_()
               for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = ref.wkv6_ref(*ins[:5], s0=ins[5], chunk=ctx.chunk)
        grads = iter(torch.autograd.grad(
            out, [t for t in ins if t is not None], (gy, gs),
            allow_unused=True))
        return tuple(None if t is None else next(grads) for t in ins) + \
            (None,)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, *, s0: Optional[torch.Tensor] = None,
         chunk: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/w [B,S,H,hd] (w in (0,1)); u [H,hd]; s0 [B,H,hd,hd] or None ->
    (y [B,S,H,hd] in r's dtype, S [B,H,hd,hd] fp32)."""
    return _WKV6.apply(r, k, v, w, u, s0, chunk)
