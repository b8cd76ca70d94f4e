"""Plain PyTorch version of the grouped PK-validation kernel."""
from __future__ import annotations

import torch

from ..phash.ref import GOLDEN, GOLDEN2, mul32, u32

#: linear-probe bound shared with the host-side HashIndex insert path —
#: the host grows the table rather than place a key further than this,
#: so a miss after MAX_PROBE steps is a real miss
MAX_PROBE = 8


def bucket_hash_ref(par: torch.Tensor, nam: torch.Tensor) -> torch.Tensor:
    """uint32 bucket mix (int64) of the composite key (parent, name hash)."""
    h = mul32(u32(par), GOLDEN) ^ mul32(u32(nam), GOLDEN2)
    return h ^ (h >> 16)


def probe_table_ref(tp: torch.Tensor, tn: torch.Tensor, tv: torch.Tensor,
                    par: torch.Tensor, nam: torch.Tensor,
                    max_probe: int = MAX_PROBE) -> torch.Tensor:
    """Linear-probe lookup of every (par, nam) in one table: value [N]
    int32, -1 on a miss, -3 passed through; parent < 0 always misses."""
    cap = tp.shape[0]
    slot = bucket_hash_ref(par, nam) & (cap - 1)
    nam64 = u32(nam)
    tn64 = u32(tn)
    out = torch.full(par.shape, -1, dtype=torch.int32, device=par.device)
    alive = par >= 0
    for step in range(max_probe):
        j = (slot + step) & (cap - 1)
        ep, en, ev = tp[j], tn64[j], tv[j]
        hit = alive & (ep >= 0) & (ep == par) & (en == nam64)
        out = torch.where(hit, ev, out)
        alive = alive & ~hit & (ep != -1)
    return out


def pkval_ref(tp: torch.Tensor, tn: torch.Tensor, tv: torch.Tensor,
              parents: torch.Tensor, name_hashes: torch.Tensor, *,
              max_probe: int = MAX_PROBE) -> torch.Tensor:
    """index tp/tn/tv [C] x probes [N] -> ids [N] int32 (-1 miss,
    -3 collided bucket).  All int32, name hashes as uint32 bit patterns."""
    return probe_table_ref(tp, tn, tv, parents, name_hashes, max_probe)
