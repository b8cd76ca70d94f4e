"""Subtree wave expansion for the subtree protocol and ``du``.

The inode table's hot columns live on the device already (the columnar
store keeps a device mirror of them); only the wave travels there (one
copy), and only the per-member sums and the children come back (two
copies: the sums with the counts, then the children's ids).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .._staging import upload_i32
from . import kernel, ref


def treeagg(wave, par, isdir, size
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor]:
    """The seg form: the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if par.is_cuda:
        return kernel.treeagg(wave, par, isdir, size)
    return ref.treeagg_ref(wave, par, isdir, size)


def treeagg_expand(wave, ids: torch.Tensor, par: torch.Tensor,
                   isdir: torch.Tensor, size: torch.Tensor
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                              np.ndarray, np.ndarray]:
    """Resolve one BFS wave against the inode table's hot columns in one
    launch on their device (the compact form).

    ``wave`` is the wave's directory ids (host, sorted ascending, unique);
    ``ids`` (int64) and ``par``/``isdir``/``size`` (int32) are the table's
    slots, cleared slots with parent ``-1``.  Returns host arrays
    ``(counts [W], dirs [W], sizes [W])`` int32, and the children's ids and
    the directories among them (int64, in slot order)."""
    (wave_t,) = upload_i32([wave], par.device)
    if par.is_cuda:
        out = kernel.treeagg_compact(wave_t, ids, par, isdir, size)
        res = kernel.unpack(out, wave_t.numel(), par.numel())
    else:
        res = ref.treeagg_expand_ref(wave_t, ids, par, isdir, size)
    return tuple(t.numpy() for t in res)
