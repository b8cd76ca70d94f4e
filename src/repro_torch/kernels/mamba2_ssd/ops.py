"""The SSD scan: the CUDA kernel for CUDA tensors, the plain version for
CPU tensors, with the reference's oracle backward.

The JAX package's ``ops.ssd`` sends a carried state ``h0`` to its jnp
reference; here the kernel takes the initial state itself, so on the card
the cache-filling prefill launches the kernel too and no plain version
runs.  The function computed is the one ``ref.ssd_ref(..., h0=h0)``
computes.  The backward differentiates the plain version, as the
reference's ``custom_vjp`` does (``repro/kernels/mamba2_ssd/ops.py``):
the JAX package has no backward kernel, its VJP of the jnp oracle runs
outside any Pallas kernel, so this is its backward, not a fallback.  With
``h0`` the reference differentiates its oracle directly, ``h0`` included;
so does this Function.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import kernel, ref


class _SSD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, Bc, Cc, h0, chunk):
        ctx.save_for_backward(x, dt, A, Bc, Cc, h0)
        ctx.chunk = chunk
        if x.is_cuda:
            return kernel.ssd_fwd(
                x.contiguous(), dt.float().contiguous(),
                A.float().contiguous(), Bc.contiguous(), Cc.contiguous(),
                h0=None if h0 is None else h0.float().contiguous(),
                chunk=chunk)
        return ref.ssd_ref(x, dt, A, Bc, Cc, h0=h0, chunk=chunk)

    @staticmethod
    def backward(ctx, gy, gh):
        ins = [None if t is None else t.detach().requires_grad_()
               for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = ref.ssd_ref(*ins[:5], h0=ins[5], chunk=ctx.chunk)
        grads = iter(torch.autograd.grad(
            out, [t for t in ins if t is not None], (gy, gh),
            allow_unused=True))
        return tuple(None if t is None else next(grads) for t in ins) + \
            (None,)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        Bc: torch.Tensor, Cc: torch.Tensor, *,
        h0: Optional[torch.Tensor] = None, chunk: int = 128
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,H,hd]; dt [B,S,H]; A [H]; Bc/Cc [B,S,N]; h0 [B,H,hd,N] ->
    (y [B,S,H,hd], h [B,H,hd,N] fp32)."""
    return _SSD.apply(x, dt, A, Bc, Cc, h0, chunk)
