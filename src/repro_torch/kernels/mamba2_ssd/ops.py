"""The SSD scan: the CUDA kernel for CUDA tensors, the plain version for
CPU tensors.

The JAX package's ``ops.ssd`` sends a carried state ``h0`` to its jnp
reference; here the kernel takes the initial state itself, so on the card
the cache-filling prefill launches the kernel too and no plain version
runs.  The function computed is the one ``ref.ssd_ref(..., h0=h0)``
computes.  (The reference's recompute-based backward waits for the
training slice of the port.)
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import kernel, ref


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        Bc: torch.Tensor, Cc: torch.Tensor, *,
        h0: Optional[torch.Tensor] = None, chunk: int = 128
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,H,hd]; dt [B,S,H]; A [H]; Bc/Cc [B,S,N]; h0 [B,H,hd,N] ->
    (y [B,S,H,hd], h [B,H,hd,N] fp32)."""
    if x.is_cuda:
        return kernel.ssd_fwd(
            x.contiguous(), dt.float().contiguous(), A.float().contiguous(),
            Bc.contiguous(), Cc.contiguous(),
            h0=None if h0 is None else h0.float().contiguous(), chunk=chunk)
    return ref.ssd_ref(x, dt, A, Bc, Cc, h0=h0, chunk=chunk)
