"""Plain PyTorch version of the subtree wave-expansion kernel."""
from __future__ import annotations

from typing import Tuple

import torch

from ..phash.ref import MASK, as_i32


def treeagg_ref(wave: torch.Tensor, par: torch.Tensor, isdir: torch.Tensor,
                size: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """wave [W] (sorted ascending) x slots par/isdir/size [C] ->
    (seg [C], counts [W], dirs [W], sizes [W]), all int32: ``seg`` is the
    wave index each slot's parent equals (-1 = none, parents < 0 never
    match), the others are per-member sums over those slots, modulo 2^32."""
    w = wave.shape[0]
    dev = par.device
    if w == 0:
        zero = torch.zeros(0, dtype=torch.int32, device=dev)
        return (torch.full(par.shape, -1, dtype=torch.int32, device=dev),
                zero, zero.clone(), zero.clone())
    idx = torch.searchsorted(wave, par)              # lower bound, int64
    found = (par >= 0) & (idx < w) & (wave[idx.clamp(max=w - 1)] == par)
    seg = torch.where(found, idx, -1).to(torch.int32)
    hit = idx[found]

    def seg_sum(vals: torch.Tensor) -> torch.Tensor:
        acc = torch.zeros(w, dtype=torch.int64, device=dev)
        acc.index_add_(0, hit, vals.to(torch.int64))
        return as_i32(acc & MASK)

    return (seg, seg_sum(torch.ones_like(hit)), seg_sum(isdir[found]),
            seg_sum(size[found]))


def treeagg_expand_ref(wave: torch.Tensor, ids: torch.Tensor,
                       par: torch.Tensor, isdir: torch.Tensor,
                       size: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor, torch.Tensor]:
    """The compact form's result, unpacked: (counts, dirs, sizes [W] int32,
    the children's ids and the directories' among them (``is_dir == 1``),
    int64 in slot order), from :func:`treeagg_ref`'s seg."""
    seg, counts, dirs, sizes = treeagg_ref(wave, par, isdir, size)
    hit = seg >= 0
    child_ids = ids[hit]
    return counts, dirs, sizes, child_ids, child_ids[isdir[hit] == 1]
