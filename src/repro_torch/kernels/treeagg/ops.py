"""Subtree wave expansion for the subtree protocol and ``du``.

The inode table's hot columns live on the device already (the columnar
store keeps a device mirror of them); only the wave travels there, and
only the per-member sums and the children come back.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..phash.ops import to_i32
from . import kernel, ref


def treeagg(wave, par, isdir, size
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor]:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if par.is_cuda:
        return kernel.treeagg(wave, par, isdir, size)
    return ref.treeagg_ref(wave, par, isdir, size)


def treeagg_expand(wave, ids: torch.Tensor, par: torch.Tensor,
                   isdir: torch.Tensor, size: torch.Tensor
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                              np.ndarray, np.ndarray]:
    """Resolve one BFS wave against the inode table's hot columns in one
    launch on their device.

    ``wave`` is the wave's directory ids (host, sorted ascending, unique);
    ``ids`` (int64) and ``par``/``isdir``/``size`` (int32) are the table's
    slots, cleared slots with parent ``-1``.  Returns host arrays
    ``(counts [W], dirs [W], sizes [W])`` int32, and the children's ids and
    the directories among them (int64, in slot order)."""
    seg, counts, dirs, sizes = treeagg(to_i32(wave, par.device), par, isdir,
                                       size)
    hit = seg >= 0
    child_ids = ids[hit]
    child_dir_ids = child_ids[isdir[hit] == 1]
    return (counts.cpu().numpy(), dirs.cpu().numpy(), sizes.cpu().numpy(),
            child_ids.cpu().numpy(), child_dir_ids.cpu().numpy())
