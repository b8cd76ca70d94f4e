"""Plain PyTorch version of the hint-chain resolution kernel."""
from __future__ import annotations

from typing import Tuple

import torch

from ..pkval.ref import MAX_PROBE, probe_table_ref


def hintchain_ref(cp, cn, cv, fp, fn, fv, name_hashes: torch.Tensor,
                  depths: torch.Tensor, *, root_id: int = 1,
                  max_probe: int = MAX_PROBE
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Walk every chain from ``root_id``, client table first, then the
    fallback table: (child ids, src) [N, D] int32 in the kernel's encoding
    (child > 0 resolved, -1 miss, -2 never probed, -3 collided bucket;
    src 0 client, 1 fallback, -1 none)."""
    n, d_max = name_hashes.shape
    dev = name_hashes.device
    dep = depths.to(torch.int32)
    parent = torch.full((n,), root_id, dtype=torch.int32, device=dev)
    alive = dep > 0
    childs = torch.full((n, d_max), -2, dtype=torch.int32, device=dev)
    srcs = torch.full((n, d_max), -1, dtype=torch.int32, device=dev)
    for d in range(d_max):
        probing = alive & (d < dep)
        nd = name_hashes[:, d]
        cval = probe_table_ref(cp, cn, cv, parent, nd, max_probe)
        fval = probe_table_ref(fp, fn, fv, parent, nd, max_probe)
        val = torch.where(cval != -1, cval, fval)
        found = probing & (val > 0)
        childs[:, d] = torch.where(probing, val, torch.full_like(val, -2))
        srcs[:, d] = torch.where(
            found & (cval > 0), torch.zeros_like(val),
            torch.where(found, torch.ones_like(val), torch.full_like(val, -1)))
        parent = torch.where(found, val, parent)
        alive = alive & found
    return childs, srcs
