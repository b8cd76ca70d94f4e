"""Grouped PK validation for the request path: host probes in, host ids out.

The index triple lives on the device already (the columnar store keeps a
device mirror of its hash index); only the probes travel.
"""
from __future__ import annotations

import numpy as np
import torch

from ..phash.ops import to_i32
from . import kernel, ref
from .ref import MAX_PROBE


def pkval(tp, tn, tv, parents, name_hashes, *, max_probe: int = MAX_PROBE
          ) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if parents.is_cuda:
        return kernel.pkval(tp, tn, tv, parents, name_hashes,
                            max_probe=max_probe)
    return ref.pkval_ref(tp, tn, tv, parents, name_hashes,
                         max_probe=max_probe)


def pkval_lookup(tp: torch.Tensor, tn: torch.Tensor, tv: torch.Tensor,
                 parents, name_hashes, *, max_probe: int = MAX_PROBE
                 ) -> np.ndarray:
    """Resolve a batch of ``(parent_id, name_hash)`` probes against an index
    triple (int32 tensors, name hashes as bit patterns) on its own device,
    in one launch.  Returns ids [N] int32: the resolved inode id, ``-1`` =
    no such row, ``-3`` = collided bucket (the caller must not trust it)."""
    n = len(parents)
    if n == 0:
        return np.zeros(0, np.int32)
    par = torch.from_numpy(np.ascontiguousarray(
        np.asarray(parents, np.int64).astype(np.int32))).to(tp.device)
    out = pkval(tp, tn, tv, par, to_i32(name_hashes, tp.device),
                max_probe=max_probe)
    return out.cpu().numpy()
