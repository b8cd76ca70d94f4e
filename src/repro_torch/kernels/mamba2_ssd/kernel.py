"""CUDA binding of the Mamba2 chunked SSD scan (``csrc/model_kernels.cu``).

Replaces the Pallas kernel ``ssd_fwd`` of the JAX package
(``repro/kernels/mamba2_ssd/kernel.py``), and takes an initial state as
well (zeros when none is given).  One block per (batch row, head) walks the
chunks in order with the state [hd, N] in fp32 shared memory; per chunk
the intra-chunk quadratic form, the carried state's term and the state
update, as ``_ssd_kernel`` computes them.  At Q=128, hd=64, N=64 it does
about 94 operations per byte it must move, below the H100's bf16 ridge
(~295), so its bound is the bytes; this first version computes on the
fp32 CUDA cores and sits far above that bound.  Any S: a ragged last chunk
is taken as it is.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import LAUNCHES
from .._build import launch, require_cuda_float

#: head dims the kernel is compiled for
HEAD_DIMS = (16, 32, 64, 128)
MAX_CHUNK = 128
MAX_STATE = 128


def ssd_fwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            Bc: torch.Tensor, Cc: torch.Tensor, *,
            h0: Optional[torch.Tensor] = None, chunk: int = 128
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,H,hd] and Bc/Cc [B,S,N] in one dtype, dt [B,S,H] and A [H]
    fp32, h0 [B,H,hd,N] fp32 or None, on the card -> (y [B,S,H,hd] in x's
    dtype, h [B,H,hd,N] fp32).  A block stages a chunk in shared memory;
    where hd and N need more than the card has (hd=64 with N above 101,
    hd=128 with N above 63) the launch is refused and this raises."""
    require_cuda_float(x=x, dt=dt, A=A, Bc=Bc, Cc=Cc)
    B, S, H, hd = x.shape
    N = Bc.shape[-1]
    if dt.shape != (B, S, H) or A.shape != (H,) or Bc.shape != (B, S, N) \
            or Cc.shape != Bc.shape:
        raise ValueError("ssd: x [B,S,H,hd], dt [B,S,H], A [H], Bc/Cc "
                         "[B,S,N]")
    if not x.dtype == Bc.dtype == Cc.dtype or dt.dtype != torch.float32 \
            or A.dtype != torch.float32:
        raise ValueError("ssd: x, Bc and Cc in one dtype; dt and A fp32")
    if hd not in HEAD_DIMS or not 1 <= N <= MAX_STATE:
        raise ValueError(f"ssd: head dim {hd} not in {HEAD_DIMS} or state "
                         f"{N} not in [1, {MAX_STATE}]")
    Q = min(chunk, max(S, 1))
    if not 1 <= Q <= MAX_CHUNK:
        raise ValueError(f"ssd: chunk {chunk} not in [1, {MAX_CHUNK}]")
    if h0 is not None:
        require_cuda_float(h0=h0)
        if h0.shape != (B, H, hd, N) or h0.dtype != torch.float32:
            raise ValueError("ssd: h0 [B,H,hd,N] fp32")
    y = torch.empty_like(x)
    h = torch.empty((B, H, hd, N), dtype=torch.float32, device=x.device)
    if B * H:
        launch("ssd_launch", x.data_ptr(), dt.data_ptr(), A.data_ptr(),
               Bc.data_ptr(), Cc.data_ptr(),
               0 if h0 is None else h0.data_ptr(), y.data_ptr(),
               h.data_ptr(), B, S, H, hd, N, Q,
               int(x.dtype == torch.bfloat16))
        LAUNCHES["ssd"] += 1
    return y, h
