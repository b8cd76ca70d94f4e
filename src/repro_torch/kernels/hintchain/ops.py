"""Hint-chain resolution for the planner: host arrays in, host arrays out.

The two hint-cache snapshots are small and rebuilt every window, so they
are copied to the device on every launch, with the window's chains.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..phash.ops import to_i32
from ..pkval.ref import MAX_PROBE
from . import kernel, ref


def hintchain(cp, cn, cv, fp, fn, fv, name_hashes, depths, *,
              root_id: int = 1, max_probe: int = MAX_PROBE
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn_ = kernel.hintchain if name_hashes.is_cuda else ref.hintchain_ref
    return fn_(cp, cn, cv, fp, fn, fv, name_hashes, depths, root_id=root_id,
               max_probe=max_probe)


def hintchain_resolve(client_idx: Sequence[np.ndarray],
                      fallback_idx: Sequence[np.ndarray], name_hashes,
                      depths, *, device: torch.device, root_id: int = 1,
                      max_probe: int = MAX_PROBE
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Resolve a whole window's hint chains in one launch on ``device``.

    ``client_idx``/``fallback_idx`` are ``HashIndex.arrays()`` triples of
    the client cache and the merged namenode caches; ``name_hashes [N, D]``
    and ``depths [N]`` describe every op's chain (depth 0 = never probed).
    Returns the kernel's (child ids, src) [N, D] int32 encoding."""
    nam = np.asarray(name_hashes)
    n = nam.shape[0]
    if n == 0:
        d0 = nam.shape[1] if nam.ndim == 2 else 0
        return (np.full((0, d0), -2, np.int32),
                np.full((0, d0), -1, np.int32))
    tables = [to_i32(a, device) for a in (*client_idx, *fallback_idx)]
    dep = torch.from_numpy(
        np.ascontiguousarray(np.asarray(depths, np.int32))).to(device)
    child, src = hintchain(*tables, to_i32(nam, device), dep,
                           root_id=root_id, max_probe=max_probe)
    return child.cpu().numpy(), src.cpu().numpy()
