"""CUDA binding of the RWKV-6 chunked WKV scan (``csrc/wkv_scan.cu``).

Replaces the Pallas kernel ``wkv6_fwd`` of the JAX package
(``repro/kernels/rwkv6_scan/kernel.py``), and takes an initial state as
well (zeros when none is given).  The chunks of Q steps are cut into
segments of G chunks (``_build.segments``): one call runs (A) each
segment's local end state from zero with its per-channel decay, (B) a
pass over the segments that turns those into each segment's start state,
and (C) the chunk loop of every segment from its start state, writing y:
B x H x segments blocks at once where the TPU kernel's sequential chunk
grid gave B x H.  The state scratch is allocated here.  Per chunk the
masked-exponent intra-chunk term, the diagonal bonus, the carried state's
term and the state update, as ``_wkv_kernel`` computes them, without the
[Q, Q, hd] pairwise tensor (the sums over channels stay in registers).
The log decay and its clamp are computed in the kernel.  At B=2, S=4096,
H=40, hd=64 it does some 30 operations per byte it must move, far below
the H100's ridge, so its bound is the bytes.  bf16 keeps the per-pair
exponentials on the CUDA cores and runs the three products on the tensor
cores (``mma.sync``, every fp32 operand as two bf16 parts); fp32 runs on
the CUDA cores with fp32 products; :data:`LAST_ROUTE` records which.  Any
S: a ragged last chunk is taken as it is (the TPU kernel dropped the
steps past the last whole chunk).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import LAUNCHES
from .._build import c_int, launch, require_cuda_float, segments

#: head dims the kernel is compiled for
HEAD_DIMS = (16, 32, 64, 128)
MAX_CHUNK = 32

#: the kernel the last call launched, as the library recorded it after
#: the launch: "tc" (bf16, products on the tensor cores)
#: or "simt" (fp32, the CUDA cores); and its plan: chunks a segment,
#: segments, bytes of state scratch
LAST_ROUTE = None
LAST_PLAN = None
_ROUTES = {-1: None, 0: "simt", 1: "tc"}


def wkv6_fwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, *,
             s0: Optional[torch.Tensor] = None, chunk: int = 32
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v [B,S,H,hd] in one dtype, w [B,S,H,hd] and u [H,hd] fp32,
    s0 [B,H,hd,hd] fp32 or bf16 or None, on the card -> (y [B,S,H,hd] in
    r's dtype, S [B,H,hd,hd] fp32)."""
    require_cuda_float(r=r, k=k, v=v, w=w, u=u)
    B, S, H, hd = r.shape
    if k.shape != r.shape or v.shape != r.shape or w.shape != r.shape \
            or u.shape != (H, hd):
        raise ValueError("wkv6: r/k/v/w [B,S,H,hd], u [H,hd]")
    if not r.dtype == k.dtype == v.dtype or w.dtype != torch.float32 \
            or u.dtype != torch.float32:
        raise ValueError("wkv6: r, k and v in one dtype; w and u fp32")
    if hd not in HEAD_DIMS:
        raise ValueError(f"wkv6: head dim {hd} not in {HEAD_DIMS}")
    Q = min(chunk, max(S, 1))
    if not 1 <= Q <= MAX_CHUNK:
        raise ValueError(f"wkv6: chunk {chunk} not in [1, {MAX_CHUNK}]")
    s0_kind = 0
    if s0 is not None:
        require_cuda_float(s0=s0)
        if s0.shape != (B, H, hd, hd):
            raise ValueError("wkv6: s0 [B,H,hd,hd]")
        s0_kind = 2 if s0.dtype == torch.bfloat16 else 1
    y = torch.empty_like(r)
    s = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    if B * H:
        global LAST_ROUTE, LAST_PLAN
        G, nseg = segments(-(-S // Q), B * H, r.device)
        # per boundary between segments: a local state and its decay
        n_loc = B * H * (nseg - 1) * hd * hd
        scratch = torch.empty(n_loc + B * H * (nseg - 1) * hd,
                              dtype=torch.float32, device=r.device)
        launch("wkv6_launch", r.data_ptr(), k.data_ptr(), v.data_ptr(),
               w.data_ptr(), u.data_ptr(),
               0 if s0 is None else s0.data_ptr(), y.data_ptr(),
               s.data_ptr(), scratch.data_ptr(), scratch[n_loc:].data_ptr(),
               B, S, H, hd, Q, G, int(r.dtype == torch.bfloat16), s0_kind)
        LAUNCHES["wkv6"] += 1
        LAST_ROUTE = _ROUTES[c_int("wkv6_last_route")]
        LAST_PLAN = {"chunks_per_segment": G, "segments": nseg,
                     "scratch_bytes": 4 * scratch.numel()}
    return y, s
