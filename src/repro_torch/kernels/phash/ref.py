"""Plain PyTorch versions of the partition-hash kernels.

uint32 arithmetic is done in int64 and masked to 32 bits; the multiply is
split in 16-bit halves so no int64 product overflows.  Inputs are int32
tensors holding uint32 bit patterns; any device.
"""
from __future__ import annotations

from typing import Tuple

import torch

GOLDEN = 0x9E3779B1
# second mix constant for the chain signature (murmur3 fmix)
GOLDEN2 = 0x85EBCA6B
MASK = 0xFFFFFFFF


def u32(t: torch.Tensor) -> torch.Tensor:
    """int64 view of a tensor's low 32 bits as an unsigned value."""
    return t.to(torch.int64) & MASK


def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for a in [0, 2^32) held in int64."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def mix32(k: torch.Tensor) -> torch.Tensor:
    h = mul32(k, GOLDEN)
    return h ^ (h >> 16)


def as_i32(h: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> their int32 bit pattern."""
    return torch.where(h >= 2**31, h - 2**32, h).to(torch.int32)


def phash_ref(keys: torch.Tensor, n_partitions: int = 64) -> torch.Tensor:
    """keys [N] -> partition ids [N] int32."""
    return (mix32(u32(keys)) % n_partitions).to(torch.int32)


def phash_chain_ref(parents: torch.Tensor, names: torch.Tensor,
                    hints: torch.Tensor, depths: torch.Tensor,
                    n_partitions: int = 64
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """parents/names [N, D], hints [N], depths [N] -> (comp [N, D] int32,
    hint parts [N] int32, signatures [N] int32 bit patterns of uint32)."""
    h = mix32(u32(parents))
    nam = u32(names)
    comp = (h % n_partitions).to(torch.int32)
    dep = depths.to(torch.int64)
    sig = torch.zeros(parents.shape[0], dtype=torch.int64,
                      device=parents.device)
    for k in range(parents.shape[1]):
        step = mul32(sig ^ h[:, k] ^ nam[:, k], GOLDEN2)
        step = step ^ (step >> 15)
        sig = torch.where(k < dep, step, sig)
    return comp, phash_ref(hints, n_partitions), as_i32(sig)
