"""CUDA binding of the flash-attention forward (``csrc/flash_tc.cu`` for
bf16, ``csrc/model_kernels.cu`` for fp32).

Replaces the Pallas kernel ``flash_attention_fwd`` of the JAX package
(``repro/kernels/flash_attention/kernel.py``): causal, sliding-window and
softcapped GQA attention with an online softmax in fp32, on bf16 or fp32
q [B,S,H,hd] and k/v [B,S,KV,hd], for any S.  At the model's shapes it is
bound by arithmetic (about S/2 operations per byte of q, k and v,
causal), so bf16 runs on the tensor cores: one block per (batch row and
head, 128 query rows), a producer warpgroup loading K and V tiles (64
keys; 128 at hd=16, 32 at hd=256) by TMA into rings of 4 slots, two consumer warpgroups of 64 rows each computing Q K^T and P V
with ``wgmma``, the scores and P kept in registers (P as two bf16 parts,
high and low, for P V: one bf16 rounding, the TPU kernel's, puts the
model path's outputs past the bf16 tolerance); one warpgroup's softmax
runs under the other's products.  fp32 runs a SIMT kernel on the CUDA cores (the tensor
cores take fp32 only as TF32).  Key tiles past the causal frontier or
before the window are skipped.  bf16 q, k and v must be 16-byte aligned
(TMA's rule), as every tensor PyTorch allocates is.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .. import LAUNCHES
from .._build import launch, require_cuda_float

#: head dims the kernel is compiled for (the smoke and full configs' dims)
HEAD_DIMS = (16, 32, 64, 80, 128, 256)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None) -> torch.Tensor:
    """q [B,S,H,hd]; k/v [B,S,KV,hd], one dtype, on the card ->
    [B,S,H,hd] in that dtype."""
    require_cuda_float(q=q, k=k, v=v)
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if k.shape != (B, S, KV, hd) or v.shape != k.shape or H % KV:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: expected "
                         f"k/v [B,S,KV,hd] with KV dividing H")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError("flash_attention: q, k and v differ in dtype")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in "
                         f"{HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v)):
        raise ValueError("flash_attention: bf16 q, k and v must be "
                         "16-byte aligned")
    out = torch.empty_like(q)
    if q.numel():
        launch("flash_attention_launch", q.data_ptr(), k.data_ptr(),
               v.data_ptr(), out.data_ptr(), B, S, H, KV, hd, int(causal),
               window or 0, float(softcap or 0.0), 1.0 / math.sqrt(hd),
               int(q.dtype == torch.bfloat16))
        LAUNCHES["flash_attention"] += 1
    return out
