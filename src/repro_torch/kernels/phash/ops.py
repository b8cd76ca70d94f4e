"""Partition hashing for the request path: host arrays in, host arrays out.

Each function moves its inputs to ``device`` as int32 tensors (uint32 keys
as their bit patterns) and runs the CUDA kernel there, or the plain
PyTorch version when ``device`` is the CPU.  No padding: the kernels take
any N.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import kernel, ref


def to_i32(a, device: torch.device) -> torch.Tensor:
    """Integer host array -> int32 tensor of its low 32 bits on device."""
    arr = np.ascontiguousarray(np.asarray(a, dtype=np.int64) & 0xFFFFFFFF)
    return torch.from_numpy(arr.astype(np.uint32).view(np.int32)).to(device)


def phash(keys: torch.Tensor, n_partitions: int = 64) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if keys.is_cuda:
        return kernel.phash(keys, n_partitions)
    return ref.phash_ref(keys, n_partitions)


def phash_chain(parents, names, hints, depths, n_partitions: int = 64
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if parents.is_cuda:
        return kernel.phash_chain(parents, names, hints, depths, n_partitions)
    return ref.phash_chain_ref(parents, names, hints, depths, n_partitions)


def phash_partitions(keys, n_partitions: int = 64, *,
                     device: torch.device) -> np.ndarray:
    """Partition ids [N] int32 for a batch of integer keys — equal to
    ``repro_torch.core.store._hash_key(key) % n_partitions`` for every key
    (both hash the low 32 bits)."""
    if len(keys) == 0:
        return np.zeros(0, np.int32)
    return phash(to_i32(keys, device), n_partitions).cpu().numpy()


def phash_chains(parent_ids, name_hashes, hint_ids, depths,
                 n_partitions: int = 64, *, device: torch.device
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-component partitions [N, D] int32, hint partitions [N] int32 and
    chain signatures [N] uint32 of a planner window, in one launch.
    ``parent_ids``/``name_hashes`` are [N, D], zero past ``depths[n]``."""
    par = np.asarray(parent_ids)
    n = par.shape[0]
    if n == 0:
        d0 = par.shape[1] if par.ndim == 2 else 0
        return (np.zeros((0, d0), np.int32), np.zeros(0, np.int32),
                np.zeros(0, np.uint32))
    dep = torch.from_numpy(
        np.ascontiguousarray(np.asarray(depths, np.int32))).to(device)
    comp, hint_parts, sigs = phash_chain(
        to_i32(par, device), to_i32(name_hashes, device),
        to_i32(hint_ids, device), dep, n_partitions)
    return (comp.cpu().numpy(), hint_parts.cpu().numpy(),
            sigs.cpu().numpy().view(np.uint32))
