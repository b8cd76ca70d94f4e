"""Host-to-card uploads of the metadata wrappers in one copy.

A wrapper that sends several small host arrays to the card packs their low
32 bits into one int32 host buffer and moves that buffer in one copy: from
page-locked memory for a card, so the copy is one asynchronous transfer
rather than one staged copy an array.  The page-locked buffers are kept in
a pool that every thread shares; a buffer goes back to the pool with an
event recorded after its copy, and is written again only once that event
has completed.
"""
from __future__ import annotations

import threading
from typing import List, Sequence, Tuple

import numpy as np
import torch

#: page-locked buffers not in use, each with the event of its last copy
_free: List[Tuple[torch.Tensor, "torch.cuda.Event"]] = []
_mu = threading.Lock()


def _take(n: int) -> Tuple[torch.Tensor, "torch.cuda.Event"]:
    """A page-locked int32 buffer of at least ``n`` whose last copy has
    been read, and its event."""
    with _mu:
        for i, (buf, ev) in enumerate(_free):
            if buf.numel() >= n:
                del _free[i]
                break
        else:
            buf = None
    if buf is None:
        return (torch.empty(max(n, 1 << 16), dtype=torch.int32,
                            pin_memory=True), torch.cuda.Event())
    ev.synchronize()
    return buf, ev


def low32(a) -> np.ndarray:
    """An integer array's low 32 bits as int32 bit patterns."""
    a = np.asarray(a)
    if a.dtype in (np.int32, np.uint32):
        return a.view(np.int32)
    return (a.astype(np.int64) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def offsets(sizes: Sequence[int]) -> List[int]:
    """Where each array starts in the packed buffer (ints): every start
    16-byte aligned, so the kernels may read each with 16-byte loads; the
    last entry is the buffer's length."""
    out = [0]
    for n in sizes:
        out.append(out[-1] + -(-n // 4) * 4)
    return out


def upload_i32(arrays: Sequence, device: torch.device) -> List[torch.Tensor]:
    """The arrays' low 32 bits as int32 tensors on ``device``, each shaped
    as its array: views of one buffer that went there in one copy (none
    for the CPU)."""
    arrs = [low32(a) for a in arrays]
    offs = offsets([a.size for a in arrs])
    on_card = torch.device(device).type == "cuda"
    if on_card:
        buf, ev = _take(offs[-1])
        host = buf[:offs[-1]]
    else:
        host = torch.empty(offs[-1], dtype=torch.int32)
    h = host.numpy()
    for a, o in zip(arrs, offs):
        h[o:o + a.size] = a.reshape(-1)
    if on_card:
        dev = host.to(device, non_blocking=True)
        ev.record()
        with _mu:
            _free.append((buf, ev))
    else:
        dev = host
    return [dev[o:o + a.size].view(a.shape) for a, o in zip(arrs, offs)]
