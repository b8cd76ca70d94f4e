"""CUDA binding of the subtree wave-expansion kernel
(``csrc/metadata_kernels.cu``).

Replaces the Pallas kernel ``treeagg`` of the JAX package
(``repro/kernels/treeagg/kernel.py``): for every inode-table slot, a
lower-bound search of its ``parent_id`` in the sorted wave gives the wave
member the slot is a child of (none for cleared slots, which carry parent
-1), and per-member int32 sums of 1, ``is_dir`` and ``size`` over those
children.

Two forms of one kernel.  :func:`treeagg` is the TPU kernel's function:
``seg`` for every slot and the sums.  :func:`treeagg_compact` is what the
subtree protocol needs (``columnar.expand_wave``): no ``seg``; the sums,
and the children's ids in slot order with the directories' among them,
compacted on the card in the same pass (a single-pass scan with decoupled
look-back over tiles of :data:`TILE_SLOTS` slots) into one packed buffer
that :func:`unpack` reads back in two copies.

The kernel reads each slot's parent once (16-byte loads) and the other
columns only for children, so it is bound by reading ``par``.  The TPU
kernel carried its sums in a revisited output block across a sequential
grid; here persistent blocks take tiles from a ticket and add their sums
with atomics, in shared memory while the wave has at most
:data:`WAVE_SMEM_CAP` members (the wave is searched there too), in device
memory above that.  Nothing is padded: any W and C.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import LAUNCHES
from .._build import launch, require_cuda_int32

#: slots a tile of the kernel covers (``kTileSlots``); one status word each
TILE_SLOTS = 4096
#: waves up to this many members are searched and summed in shared memory
#: (``kWaveSmemCap``)
WAVE_SMEM_CAP = 8192


def layout(w: int, c: int) -> Tuple[int, int, int]:
    """Where the packed buffer's parts start, in int32 elements, for a wave
    of ``w`` and ``c`` slots: (status words, the children's span, length).

    ``[counts w | dirs w | sizes w | n_children | n_dirs | ticket]``, a
    status word (int64) a tile, room for ``c`` directory ids (int64) that
    end at the second offset, where room for ``c`` child ids (int64)
    starts."""
    status = (3 * w + 3 + 1) // 2 * 2
    mid = status + 2 * -(-c // TILE_SLOTS) + 2 * c
    return status, mid, mid + 2 * c


def _check(wave, par, isdir, size):
    require_cuda_int32(wave=wave, par=par, isdir=isdir, size=size)
    if wave.dim() != 1 or par.dim() != 1 or isdir.shape != par.shape \
            or size.shape != par.shape:
        raise ValueError("treeagg: wave must be [W], par/isdir/size [C]")


def treeagg(wave: torch.Tensor, par: torch.Tensor, isdir: torch.Tensor,
            size: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor]:
    """The seg form: wave [W] (sorted ascending) x slots par/isdir/size [C]
    -> (seg [C], counts [W], dirs [W], sizes [W]), all int32 tensors on
    the card."""
    _check(wave, par, isdir, size)
    (w,) = wave.shape
    (n,) = par.shape
    seg = torch.empty_like(par)
    status, _, _ = layout(w, n)
    out = torch.empty(status, dtype=torch.int32, device=par.device)
    launch("treeagg_launch", wave.data_ptr(), w, par.data_ptr(),
           isdir.data_ptr(), size.data_ptr(), None, seg.data_ptr(),
           out.data_ptr(), status, status, n)
    if n:
        LAUNCHES["treeagg"] += 1
    return seg, out[:w], out[w:2 * w], out[2 * w:3 * w]


def treeagg_compact(wave: torch.Tensor, ids: torch.Tensor, par: torch.Tensor,
                    isdir: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """The compact form: wave [W] (sorted ascending) x slots ids (int64) and
    par/isdir/size (int32) [C] -> the packed int32 buffer on the card
    (:func:`layout`; read it with :func:`unpack`)."""
    _check(wave, par, isdir, size)
    if not isinstance(ids, torch.Tensor) or not ids.is_cuda \
            or ids.dtype != torch.int64 or not ids.is_contiguous() \
            or ids.shape != par.shape:
        raise ValueError("treeagg: ids must be a contiguous int64 [C] "
                         "tensor on the card")
    (w,) = wave.shape
    (n,) = par.shape
    status, mid, total = layout(w, n)
    out = torch.empty(total, dtype=torch.int32, device=par.device)
    launch("treeagg_launch", wave.data_ptr(), w, par.data_ptr(),
           isdir.data_ptr(), size.data_ptr(), ids.data_ptr(), None,
           out.data_ptr(), status, mid, n)
    if n:
        LAUNCHES["treeagg"] += 1
    return out


def unpack(out: torch.Tensor, w: int, c: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                      torch.Tensor, torch.Tensor]:
    """A packed buffer of :func:`treeagg_compact` (wave of ``w``, ``c``
    slots) -> host tensors (counts, dirs, sizes [W] int32, the children's
    ids and the directories' among them, int64 in slot order), in two
    copies from the card: the header, then the children's span (skipped
    when there are no children)."""
    head = out[:3 * w + 2].cpu()
    n_children, n_dirs = int(head[3 * w]), int(head[3 * w + 1])
    _, mid, _ = layout(w, c)
    if n_children:
        span = out[mid - 2 * n_dirs:mid + 2 * n_children].cpu()
        dir_ids = span[:2 * n_dirs].view(torch.int64).flip(0)
        child_ids = span[2 * n_dirs:].view(torch.int64)
    else:
        child_ids = dir_ids = torch.zeros(0, dtype=torch.int64)
    return head[:w], head[w:2 * w], head[2 * w:3 * w], child_ids, dir_ids
