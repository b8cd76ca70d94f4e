"""CUDA binding of the hint-chain resolution kernel
(``csrc/metadata_kernels.cu``).

Replaces the Pallas kernel ``hintchain`` of the JAX package
(``repro/kernels/hintchain/kernel.py``): per op, walk from ``root_id`` at
most D steps; each step probes the client table and the fallback table,
and a client answer other than a miss wins (an AMBIG answer included).
Output per (op, depth): child > 0 resolved (src 0 client, 1 fallback),
-1 miss, -2 never probed, -3 collided bucket (the host resolves that op
again exactly).

The walk is a chain of D dependent probe steps, so it is bound by the
latency of each step.  Where both tables' probe keys fit in a block's
shared memory (:func:`route_for`: parent and name, 8 bytes a slot, at most
:data:`SMEM_CAP` bytes), each block copies them there with the TMA's 1-D
bulk copy, with the values too where all 12 bytes a slot fit, and walks
against them (route ``smem``); larger tables are walked in device memory
(route ``global``).  A depth's two probes are issued together, one thread
walks one op and stops at the op's depth or first miss (the TPU version
probed every depth of every op), and blocks of 64 threads spread a window
over many SMs.  :data:`LAST_ROUTE` records the route of the last launch.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import LAUNCHES
from .._build import c_int, launch, require_cuda_int32
from ..pkval.ref import MAX_PROBE

#: table bytes that route ``smem`` holds in a block's shared memory
#: (``kHcSmemCap``)
SMEM_CAP = 200 * 1024
#: the route of the last launch: "smem" or "global"
LAST_ROUTE = None
_ROUTES = {-1: None, 0: "global", 1: "smem"}


def route_for(ccap: int, fcap: int) -> str:
    """The route the library takes for tables of ``ccap`` and ``fcap``
    slots: the four key arrays, each rounded up to 16 bytes, in shared
    memory, or not."""
    keys = 8 * (-(-ccap // 4) * 4 + -(-fcap // 4) * 4)
    return "smem" if keys <= SMEM_CAP else "global"


def hintchain(cp: torch.Tensor, cn: torch.Tensor, cv: torch.Tensor,
              fp: torch.Tensor, fn: torch.Tensor, fv: torch.Tensor,
              name_hashes: torch.Tensor, depths: torch.Tensor, *,
              root_id: int = 1, max_probe: int = MAX_PROBE,
              out: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """client table [Cc] x fallback table [Cf] x chains [N, D] ->
    (child ids [N, D], src [N, D]), int32 tensors on the card: the two
    halves of ``out`` [2, N, D] (allocated when not given)."""
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
    if out is None:
        out = torch.empty((2, n, d), dtype=torch.int32,
                          device=name_hashes.device)
    else:
        require_cuda_int32(out=out)
        if out.shape != (2, n, d):
            raise ValueError("hintchain: out must be [2, N, D]")
    if n:
        global LAST_ROUTE
        launch("hintchain_launch", cp.data_ptr(), cn.data_ptr(),
               cv.data_ptr(), cp.numel(), fp.data_ptr(), fn.data_ptr(),
               fv.data_ptr(), fp.numel(), name_hashes.data_ptr(),
               depths.data_ptr(), out.data_ptr(), n, d, root_id, max_probe)
        LAUNCHES["hintchain"] += 1
        LAST_ROUTE = _ROUTES[c_int("hintchain_last_route")]
    return out[0], out[1]
