"""CUDA binding of the grouped expert matmul (``csrc/model_kernels.cu``).

Replaces the Pallas kernel ``gmm`` of the JAX package
(``repro/kernels/moe_gmm/kernel.py``): y[e] = x[e] @ w[e] for E experts in
one launch, with an fp32 accumulator, on bf16 or fp32 inputs.  One block
per (expert, 64-row tile of C, 64-column tile of F) walks D in steps of
16, the two operand tiles staged in shared memory as fp32, each thread a
4 x 4 register tile of the sums.  At qwen3-moe's expert shape (E=128,
C=640, D=2048, F=768) it does some 300 operations per byte, at the H100's
bf16 ridge, so its bound is the arithmetic on the tensor cores; this first
version does it on the fp32 CUDA cores.  Any C, D and F: the ragged edge
tiles are masked (the TPU kernel's grid dropped a remainder block).
"""
from __future__ import annotations

import torch

from .. import LAUNCHES
from .._build import launch, require_cuda_float


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
    y = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    if y.numel():
        launch("gmm_launch", x.data_ptr(), w.data_ptr(), y.data_ptr(), E, C,
               D, F, int(x.dtype == torch.bfloat16))
        LAUNCHES["gmm"] += 1
    return y
