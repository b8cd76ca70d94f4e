"""CUDA bindings of the partition-hash kernels (``csrc/metadata_kernels.cu``).

``phash`` replaces the Pallas kernel ``phash`` of the JAX package
(``repro/kernels/phash/kernel.py``): per key
``h = key * 0x9E3779B1 mod 2^32; h ^= h >> 16; part = h % P``.
``phash_chain`` replaces ``phash_chain`` of the same file: per path row the
partition of every component's parent id, the partition of the hint id,
and the chain signature folded through ``0x85EBCA6B`` over the row's first
``depth`` components.

``phash`` is bound by device-memory traffic (8 bytes moved per key, a
handful of integer operations): one thread per key with a grid-stride
loop.  ``phash_chain`` takes a tile of 16 rows a block: the block reads the
tile's parents and names coalesced (16-byte loads where it can), writes
the component partitions coalesced, and folds each row's signature from
the tile it left in shared memory.  Its three outputs are parts of one packed int32 buffer
(:func:`layout`), so that a caller brings them back in one copy.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import LAUNCHES
from .._build import launch, require_cuda_int32

#: the deepest row the kernel takes: one row's fold operands, D rounded up
#: to odd, fit in its 48 KB of shared memory (``kPcSmemCap``)
MAX_DEPTH = 12 * 1024 - 1


def layout(n: int, d: int) -> Tuple[int, int, int]:
    """Where hint parts and signatures start in the packed output of ``n``
    rows of ``d`` components, and its length (ints):
    ``[comp n*d | hint parts n | signatures n]``."""
    return n * d, n * d + n, n * d + 2 * n


def unpack(out, n: int, d: int):
    """The three parts of a packed output (a tensor or a host array):
    comp [n, d], hint parts [n], signatures [n]."""
    hint_at, sig_at, total = layout(n, d)
    return out[:hint_at].reshape(n, d), out[hint_at:sig_at], \
        out[sig_at:total]


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
                n_partitions: int = 64, *, out: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """parents/names [N, D], hints/depths [N], all int32 on the card ->
    (comp [N, D], hint parts [N], signatures [N]) int32: the parts of the
    packed buffer ``out`` [N*D + 2N] (allocated when not given)."""
    require_cuda_int32(parents=parents, names=names, hints=hints,
                       depths=depths)
    n, d = parents.shape
    if names.shape != (n, d) or hints.shape != (n,) or depths.shape != (n,):
        raise ValueError("phash_chain: parents/names [N, D], hints and "
                         "depths [N]")
    if d > MAX_DEPTH:
        raise ValueError(f"phash_chain: D above {MAX_DEPTH}: {d}")
    hint_at, sig_at, total = layout(n, d)
    if out is None:
        out = torch.empty(total, dtype=torch.int32, device=parents.device)
    else:
        require_cuda_int32(out=out)
        if out.shape != (total,):
            raise ValueError(f"phash_chain: out must be [{total}]")
    if n:
        at = out.data_ptr()
        launch("phash_chain_launch", parents.data_ptr(), names.data_ptr(),
               hints.data_ptr(), depths.data_ptr(), at, at + 4 * hint_at,
               at + 4 * sig_at, n, d, n_partitions)
        LAUNCHES["phash_chain"] += 1
    return unpack(out, n, d)
