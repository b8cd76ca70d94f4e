"""CUDA binding of the Mamba2 chunked SSD scan (``csrc/ssd_scan.cu``).

Replaces the Pallas kernel ``ssd_fwd`` of the JAX package
(``repro/kernels/mamba2_ssd/kernel.py``), and takes an initial state as
well (zeros when none is given).  The chunks are cut into segments of G
chunks (``_build.segments``): one call runs (A) each segment's local end
state from zero, (B) a pass over the segments that turns those into each
segment's start state, and (C) the chunk loop of every segment from its
start state, writing y; B x H x segments blocks run at once where the TPU
kernel's sequential chunk grid gave B x H.  The state scratch is allocated
here.  At Q=128, hd=64, N=64 the scan does about 94 operations per byte it
must move, below the H100's bf16 ridge (~295), so its bound is the bytes.
bf16 runs on the tensor cores (``mma.sync``, every fp32 operand as two
bf16 parts); fp32 on the CUDA cores with fp32 products (the tensor cores
take fp32 only as TF32); :data:`LAST_ROUTE` records which.  Any S: a
ragged last chunk is taken as it is.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import LAUNCHES
from .._build import c_int, launch, require_cuda_float, segments

#: head dims the kernel is compiled for
HEAD_DIMS = (16, 32, 64, 128)
MAX_CHUNK = 128
MAX_STATE = 128

#: the kernel the last call launched, as the library recorded it after
#: the launch: "tc" (bf16, the tensor cores) or "simt"
#: (fp32, the CUDA cores); and its plan: chunks a segment, segments, bytes
#: of state scratch
LAST_ROUTE = None
LAST_PLAN = None
_ROUTES = {-1: None, 0: "simt", 1: "tc"}


def ssd_fwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            Bc: torch.Tensor, Cc: torch.Tensor, *,
            h0: Optional[torch.Tensor] = None, chunk: int = 128
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,H,hd] and Bc/Cc [B,S,N] in one dtype, dt [B,S,H] and A [H]
    fp32, h0 [B,H,hd,N] fp32 or None, on the card -> (y [B,S,H,hd] in x's
    dtype, h [B,H,hd,N] fp32).  A block stages a chunk in shared memory;
    where hd and N need more than the card has (fp32: hd=64 with N above
    101, hd=128 with N above 63) the launch is refused and this raises."""
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
        global LAST_ROUTE, LAST_PLAN
        G, nseg = segments(-(-S // Q), B * H, x.device)
        # per boundary between segments: a local state and its decay
        n_loc = B * H * (nseg - 1) * hd * N
        scratch = torch.empty(n_loc + B * H * (nseg - 1),
                              dtype=torch.float32, device=x.device)
        launch("ssd_launch", x.data_ptr(), dt.data_ptr(), A.data_ptr(),
               Bc.data_ptr(), Cc.data_ptr(),
               0 if h0 is None else h0.data_ptr(), y.data_ptr(),
               h.data_ptr(), scratch.data_ptr(), scratch[n_loc:].data_ptr(),
               B, S, H, hd, N, Q, G, int(x.dtype == torch.bfloat16))
        LAUNCHES["ssd"] += 1
        LAST_ROUTE = _ROUTES[c_int("ssd_last_route")]
        LAST_PLAN = {"chunks_per_segment": G, "segments": nseg,
                     "scratch_bytes": 4 * scratch.numel()}
    return y, h
