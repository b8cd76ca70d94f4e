"""CUDA binding of the grouped PK-validation kernel
(``csrc/metadata_kernels.cu``).

Replaces the Pallas kernel ``pkval`` of the JAX package
(``repro/kernels/pkval/kernel.py``): every ``(parent, name_hash)`` probe
walks the same linear-probe sequence the host :class:`HashIndex` inserts
along (at most ``MAX_PROBE`` slots), against the index's read-only
``tp/tn/tv`` arrays, which stay resident on the card.  EMPTY (-1) ends a
chain, a tombstone (-2) is stepped over, AMBIG (-3) values pass through,
and probes with parent ``< 0`` miss.

The inode index is larger than L2, so the kernel is bound by the latency
of its reads: a lane group of 8 takes each probe, and every lane reads
the three arrays at one slot of the probe's window at once (one round trip
to device memory a window of 8 slots, not up to three a slot); two warp
ballots give the first slot that holds the key or is EMPTY
(:func:`~.ref.probe_window_ref` is the same function in plain PyTorch).
Blocks of 128 threads take 16 probes each, so a few thousand probes spread
over the card; no padding of N.
"""
from __future__ import annotations

import torch

from .. import LAUNCHES
from .._build import launch, require_cuda_int32
from .ref import MAX_PROBE


def pkval(tp: torch.Tensor, tn: torch.Tensor, tv: torch.Tensor,
          parents: torch.Tensor, name_hashes: torch.Tensor, *,
          max_probe: int = MAX_PROBE) -> torch.Tensor:
    """index tp/tn/tv [C] (C a power of two) x probes [N] -> ids [N] int32,
    all int32 tensors on the card."""
    require_cuda_int32(tp=tp, tn=tn, tv=tv, parents=parents,
                       name_hashes=name_hashes)
    (cap,) = tp.shape
    if cap & (cap - 1) or tn.shape != (cap,) or tv.shape != (cap,):
        raise ValueError("pkval: tp/tn/tv must share one power-of-two size")
    if name_hashes.shape != parents.shape or parents.dim() != 1:
        raise ValueError("pkval: parents and name_hashes must be [N]")
    out = torch.empty_like(parents)
    n = parents.numel()
    if n:
        launch("pkval_launch", tp.data_ptr(), tn.data_ptr(), tv.data_ptr(),
               cap, parents.data_ptr(), name_hashes.data_ptr(),
               out.data_ptr(), n, max_probe)
        LAUNCHES["pkval"] += 1
    return out
