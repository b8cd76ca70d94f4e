"""CUDA binding of the hint-chain resolution kernel
(``csrc/metadata_kernels.cu``).

Replaces the Pallas kernel ``hintchain`` of the JAX package
(``repro/kernels/hintchain/kernel.py``): per op, walk from ``root_id`` at
most D steps; each step probes the client table, then the fallback table,
and a client answer other than a miss wins (an AMBIG answer included).
Output per (op, depth): child > 0 resolved (src 0 client, 1 fallback),
-1 miss, -2 never probed, -3 collided bucket (the host resolves that op
again exactly).

The walk is a chain of dependent gathers into two small hash tables, so it
is bound by memory latency; the kernel is one thread per op and stops
probing at the op's depth or first miss, where the TPU version probed
every depth of every op.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import LAUNCHES
from .._build import launch, require_cuda_int32
from ..pkval.ref import MAX_PROBE


def hintchain(cp: torch.Tensor, cn: torch.Tensor, cv: torch.Tensor,
              fp: torch.Tensor, fn: torch.Tensor, fv: torch.Tensor,
              name_hashes: torch.Tensor, depths: torch.Tensor, *,
              root_id: int = 1, max_probe: int = MAX_PROBE
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """client table [Cc] x fallback table [Cf] x chains [N, D] ->
    (child ids [N, D], src [N, D]), all int32 tensors on the card."""
    require_cuda_int32(cp=cp, cn=cn, cv=cv, fp=fp, fn=fn, fv=fv,
                       name_hashes=name_hashes, depths=depths)
    for tag, (p, m, v) in (("client", (cp, cn, cv)),
                           ("fallback", (fp, fn, fv))):
        (cap,) = p.shape
        if cap & (cap - 1) or m.shape != (cap,) or v.shape != (cap,):
            raise ValueError(f"hintchain: {tag} table arrays must share one "
                             "power-of-two size")
    n, d = name_hashes.shape
    if depths.shape != (n,):
        raise ValueError("hintchain: depths must be [N]")
    child = torch.empty_like(name_hashes)
    src = torch.empty_like(name_hashes)
    if n:
        launch("hintchain_launch", cp.data_ptr(), cn.data_ptr(),
               cv.data_ptr(), cp.numel(), fp.data_ptr(), fn.data_ptr(),
               fv.data_ptr(), fp.numel(), name_hashes.data_ptr(),
               depths.data_ptr(), child.data_ptr(), src.data_ptr(), n, d,
               root_id, max_probe)
        LAUNCHES["hintchain"] += 1
    return child, src
