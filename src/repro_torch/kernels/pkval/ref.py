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


#: slots of one probe window, read at once: the kernel's lanes a probe
WINDOW = 8


def probe_window_ref(tp: torch.Tensor, tn: torch.Tensor, tv: torch.Tensor,
                     par: torch.Tensor, nam: torch.Tensor,
                     max_probe: int = MAX_PROBE) -> torch.Tensor:
    """The kernel's form of :func:`probe_table_ref`: each probe reads a
    window of ``WINDOW`` slots at once, and its answer is the first slot
    of the window that holds the key (that slot's value) or EMPTY (-1);
    windows follow in turn while neither shows, up to ``max_probe``
    slots.  Equal to the step loop, bit for bit."""
    cap = tp.shape[0]
    home = bucket_hash_ref(par, nam) & (cap - 1)
    nam64, tn64 = u32(nam), u32(tn)
    out = torch.full(par.shape, -1, dtype=torch.int32, device=par.device)
    open_ = par >= 0
    lanes = torch.arange(WINDOW, device=par.device)
    for w0 in range(0, max_probe, WINDOW):
        inside = w0 + lanes < max_probe                        # [W]
        j = (home[:, None] + w0 + lanes) & (cap - 1)           # [N, W]
        ep = tp[j]
        hit = inside & (ep >= 0) & (ep == par[:, None]) \
            & (tn64[j] == nam64[:, None])
        ends = hit | (inside & (ep == -1))
        first = ends.to(torch.int32).argmax(1, keepdim=True)
        val = torch.where(hit.gather(1, first), tv[j].gather(1, first),
                          torch.full_like(first, -1, dtype=torch.int32))
        found = open_ & ends.any(1)
        out = torch.where(found, val.squeeze(1), out)
        open_ = open_ & ~found
    return out


def pkval_ref(tp: torch.Tensor, tn: torch.Tensor, tv: torch.Tensor,
              parents: torch.Tensor, name_hashes: torch.Tensor, *,
              max_probe: int = MAX_PROBE) -> torch.Tensor:
    """index tp/tn/tv [C] x probes [N] -> ids [N] int32 (-1 miss,
    -3 collided bucket).  All int32, name hashes as uint32 bit patterns."""
    return probe_table_ref(tp, tn, tv, parents, name_hashes, max_probe)
