"""CUDA binding of the subtree wave-expansion kernel
(``csrc/metadata_kernels.cu``).

Replaces the Pallas kernel ``treeagg`` of the JAX package
(``repro/kernels/treeagg/kernel.py``): for every inode-table slot, a
lower-bound search of its ``parent_id`` in the sorted wave gives ``seg``,
the wave member the slot is a child of (-1 = none; cleared slots carry
parent -1), and per-member int32 sums of 1, ``is_dir`` and ``size`` over
those children.

The kernel reads each slot's parent once and writes ``seg`` once, so it is
bound by device-memory traffic; the wave is small and stays in cache.  The
TPU kernel carried its sums in a revisited output block across a
sequential grid; here blocks run in parallel, so the sums are atomics,
aggregated within each warp first (a directory's children sit in runs of
neighbouring slots).  Nothing is padded: any W and C.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import LAUNCHES
from .._build import launch, require_cuda_int32


def treeagg(wave: torch.Tensor, par: torch.Tensor, isdir: torch.Tensor,
            size: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor]:
    """wave [W] (sorted ascending) x slots par/isdir/size [C] -> (seg [C],
    counts [W], dirs [W], sizes [W]), all int32 tensors on the card."""
    require_cuda_int32(wave=wave, par=par, isdir=isdir, size=size)
    if wave.dim() != 1 or par.dim() != 1 or isdir.shape != par.shape \
            or size.shape != par.shape:
        raise ValueError("treeagg: wave must be [W], par/isdir/size [C]")
    (w,) = wave.shape
    (n,) = par.shape
    seg = torch.empty_like(par)
    counts = torch.zeros_like(wave)
    dirs = torch.zeros_like(wave)
    sizes = torch.zeros_like(wave)
    if n:
        launch("treeagg_launch", wave.data_ptr(), w, par.data_ptr(),
               isdir.data_ptr(), size.data_ptr(), seg.data_ptr(),
               counts.data_ptr(), dirs.data_ptr(), sizes.data_ptr(), n)
        LAUNCHES["treeagg"] += 1
    return seg, counts, dirs, sizes
