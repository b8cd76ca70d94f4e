"""CUDA bindings of the partition-hash kernels (``csrc/metadata_kernels.cu``).

``phash`` replaces the Pallas kernel ``phash`` of the JAX package
(``repro/kernels/phash/kernel.py``): per key
``h = key * 0x9E3779B1 mod 2^32; h ^= h >> 16; part = h % P``.
``phash_chain`` replaces ``phash_chain`` of the same file: per path row the
partition of every component's parent id, the partition of the hint id,
and the chain signature folded through ``0x85EBCA6B`` over the row's first
``depth`` components.

Both are bound by device-memory traffic (8 bytes moved per key, a handful
of integer operations), so the kernels are one thread per key or per row
with a grid-stride loop and no shared memory.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import LAUNCHES
from .._build import launch, require_cuda_int32


def phash(keys: torch.Tensor, n_partitions: int = 64) -> torch.Tensor:
    """keys [N] int32 (uint32 bit patterns) on the card -> parts [N] int32."""
    require_cuda_int32(keys=keys)
    out = torch.empty_like(keys)
    n = keys.numel()
    if n:
        launch("phash_launch", keys.data_ptr(), out.data_ptr(), n,
               n_partitions)
        LAUNCHES["phash"] += 1
    return out


def phash_chain(parents: torch.Tensor, names: torch.Tensor,
                hints: torch.Tensor, depths: torch.Tensor,
                n_partitions: int = 64
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """parents/names [N, D], hints/depths [N], all int32 on the card ->
    (comp [N, D], hint parts [N], signatures [N]) int32."""
    require_cuda_int32(parents=parents, names=names, hints=hints,
                       depths=depths)
    n, d = parents.shape
    if names.shape != (n, d) or hints.shape != (n,) or depths.shape != (n,):
        raise ValueError("phash_chain: parents/names [N, D], hints and "
                         "depths [N]")
    comp = torch.empty_like(parents)
    hint_parts = torch.empty_like(hints)
    sigs = torch.empty_like(hints)
    if n:
        launch("phash_chain_launch", parents.data_ptr(), names.data_ptr(),
               hints.data_ptr(), depths.data_ptr(), comp.data_ptr(),
               hint_parts.data_ptr(), sigs.data_ptr(), n, d, n_partitions)
        LAUNCHES["phash_chain"] += 1
    return comp, hint_parts, sigs
