"""Host-to-card uploads and card-to-host copies of the metadata wrappers,
one copy each way.

A wrapper that sends several small host arrays to the card packs their low
32 bits into one int32 host buffer and moves that buffer in one copy: from
page-locked memory for a card, so the copy is one DMA transfer rather than
one staged copy an array.  Its results come back the same way, in one copy
of one int32 buffer into page-locked memory, and are copied out of it.
Each thread has one page-locked buffer (made once, grown when too small)
for both, and both copies are synchronous: the buffer is free again when
the copy returns, so no pool, lock or event guards it.  On a small call
the host's work is the cost (each PyTorch call from Python costs
microseconds, more than these copies take on the card), so both helpers
make as few PyTorch calls as they can.
"""
from __future__ import annotations

import threading
from typing import List, Sequence, Tuple

import numpy as np
import torch

#: each thread's page-locked int32 buffer and its numpy view
_local = threading.local()


def _pinned(n: int) -> Tuple[torch.Tensor, np.ndarray]:
    """The calling thread's page-locked buffer of at least ``n`` ints."""
    buf = getattr(_local, "buf", None)
    if buf is None or buf[0].numel() < n:
        t = torch.empty(max(n, 1 << 16), dtype=torch.int32, pin_memory=True)
        buf = _local.buf = (t, t.numpy())
    return buf


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
        buf, h = _pinned(offs[-1])
    else:
        buf = torch.empty(offs[-1], dtype=torch.int32)
        h = buf.numpy()
    for a, o in zip(arrs, offs):
        h[o:o + a.size] = a.reshape(-1)
    # synchronous: the thread's buffer may be written again on return
    dev = buf[:offs[-1]].to(device) if on_card else buf
    # every array and the padding after it, cut in one call
    sizes = [k for a, o, e in zip(arrs, offs, offs[1:])
             for k in (a.size, e - o - a.size)]
    parts = dev.split_with_sizes(sizes)[::2]
    return [p if a.ndim == 1 else p.view(a.shape)
            for p, a in zip(parts, arrs)]


def download_i32(t: torch.Tensor) -> np.ndarray:
    """An int32 tensor's values as a host array of its own (of its shape):
    from a card in one synchronous copy into the calling thread's
    page-locked buffer, then copied out of it; a CPU tensor's as they
    are."""
    if not t.is_cuda:
        return t.numpy()
    n = t.numel()
    buf, h = _pinned(n)
    buf[:n].copy_(t.reshape(-1))        # returns once the copy has landed
    return h[:n].reshape(t.shape).copy()
