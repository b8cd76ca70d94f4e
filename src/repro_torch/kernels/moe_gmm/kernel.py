"""CUDA binding of the grouped expert matmul (``csrc/gmm_tc.cu`` for bf16,
``csrc/model_kernels.cu`` for fp32).

Replaces the Pallas kernel ``gmm`` of the JAX package
(``repro/kernels/moe_gmm/kernel.py``): y[e] = x[e] @ w[e] for E experts in
one launch, with fp32 sums.  At qwen3-moe's expert shape (E=128, C=640,
D=2048, F=768) it does some 300 operations per byte, at the H100's bf16
ridge, so its bound is the arithmetic on the tensor cores.  bf16 runs
there: one block per (256-column tile of F, 128-row tile of C, expert), a
producer warpgroup filling a 4-stage ring of swizzled x and w tiles (64
deep in D) and two consumer warpgroups issuing ``wgmma`` into fp32
registers, w read MN-major as it lies.  The ring is filled by TMA when D
and F are multiples of 8 (16-byte row strides) and the operands 16-byte
aligned, else by plain loads into the same layout; :data:`LAST_ROUTE`
records which.  fp32 runs a tiled SIMT kernel on the CUDA cores (128 x
128 tiles, 8 x 8 sums a thread): the tensor cores take fp32 only as TF32.
Any C, D and F: the edges are read as zeros and not written (the TPU
kernel's grid dropped a remainder block).
"""
from __future__ import annotations

import torch

from .. import LAUNCHES
from .._build import c_int, launch, require_cuda_float

#: the route of the last launch: "tma" or "loads" (bf16, the tensor-core
#: kernel fed by TMA or by plain loads), "simt" (fp32)
LAST_ROUTE = None
_ROUTES = {0: "simt", 1: "tma", 2: "loads"}


def gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [E, C, D] @ w [E, D, F] in one dtype, on the card -> [E, C, F]
    in that dtype."""
    require_cuda_float(x=x, w=w)
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0] \
            or w.shape[1] != x.shape[2]:
        raise ValueError(f"gmm: x {tuple(x.shape)}, w {tuple(w.shape)}: "
                         f"expected x [E,C,D], w [E,D,F]")
    if x.dtype != w.dtype:
        raise ValueError("gmm: x and w differ in dtype")
    E, C, D = x.shape
    F = w.shape[2]
    global LAST_ROUTE
    y = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    if y.numel():
        launch("gmm_launch", x.data_ptr(), w.data_ptr(), y.data_ptr(), E, C,
               D, F, int(x.dtype == torch.bfloat16))
        LAUNCHES["gmm"] += 1
        LAST_ROUTE = _ROUTES[c_int("gmm_last_route")]
    return y
