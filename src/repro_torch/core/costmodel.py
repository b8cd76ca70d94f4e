"""Paper cost models: Table 3 (round trips per op) and Table 2 (capacity).

Table 3 counts database **round trips** per file-system op as a function of
path depth N, for (a) no inode-hint cache and (b) cache hits. One round trip
is a single PK op, one batch, one PPIS, one IS, or one FTS. ``f_s`` is file
size (0 = empty); we expose both variants.

These symbolic formulas are compared against the *measured* OpCost profiles
of the live implementation (the JAX package's
``benchmarks/bench_table3_costmodel.py`` does so for the reference).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from .tables import (NDB_MAX_DATANODES, NDB_MAX_RAM_PER_NODE_GB,
                     hdfs_capacity_files, hopsfs_capacity_files)


@dataclass(frozen=True)
class RTBreakdown:
    """Round trips by access path (the Table 3 vocabulary)."""
    pk_rc: int = 0
    pk_r: int = 0
    pk_w: int = 0
    batches: int = 0
    ppis: int = 0
    is_scans: int = 0

    @property
    def total(self) -> int:
        return (self.pk_rc + self.pk_r + self.pk_w + self.batches
                + self.ppis + self.is_scans)


def table3(op: str, n: int, *, cached: bool, empty_file: bool = True,
           is_dir: bool = False) -> RTBreakdown:
    """Paper Table 3 formulas (inode ops only; subtree ops are sums over
    the tree and are benchmarked structurally instead)."""
    e = empty_file
    if op == "mkdir":
        return (RTBreakdown(pk_w=2, batches=2) if cached
                else RTBreakdown(pk_rc=n - 2, pk_w=2, batches=1))
    if op == "create":  # empty-file create excl. addBlock terms
        ppis = 2 if e else 8
        return (RTBreakdown(pk_w=5, batches=4, ppis=ppis) if cached
                else RTBreakdown(pk_rc=2 * n - 3, pk_w=5, batches=2,
                                 ppis=ppis))
    if op == "addblk":
        ppis = 2 if e else 6
        return (RTBreakdown(pk_w=1, pk_r=1, batches=2, ppis=ppis) if cached
                else RTBreakdown(pk_rc=n - 1, pk_w=1, pk_r=1, batches=1,
                                 ppis=ppis))
    if op == "read":
        ppis = 1 if e else 5
        return (RTBreakdown(pk_r=1, batches=2, ppis=ppis) if cached
                else RTBreakdown(pk_rc=n - 1, pk_r=1, batches=1, ppis=ppis))
    if op == "ls":
        ppis = 1 if is_dir else 0
        return (RTBreakdown(pk_r=1, batches=1, ppis=ppis) if cached
                else RTBreakdown(pk_rc=n - 1, pk_r=1, ppis=ppis))
    if op == "stat":
        return (RTBreakdown(pk_r=1, batches=2) if cached
                else RTBreakdown(pk_rc=n - 1, pk_r=1, batches=1))
    if op == "chmod":
        extra = dict(is_scans=1) if is_dir else dict(ppis=1)
        return (RTBreakdown(pk_w=2, batches=4, **extra) if cached
                else RTBreakdown(pk_rc=2 * n - 2, pk_w=2, batches=2,
                                 **extra))
    if op == "delete":  # file delete
        ppis = 2 if e else 7
        return (RTBreakdown(pk_w=2, batches=4, ppis=ppis) if cached
                else RTBreakdown(pk_rc=2 * n - 2, pk_w=2, batches=2,
                                 ppis=ppis))
    raise KeyError(op)


# -- the worked example from §7.7 -------------------------------------------

def create_depth10_roundtrips() -> Dict[str, int]:
    """Paper: create /1/d2/.../d9/f at N=10 costs 26 RTs without the cache
    and 11 with, a saving of 15 RTs ≈ 58%."""
    miss = table3("create", 10, cached=False).total
    hit = table3("create", 10, cached=True).total
    return {"no_cache": miss, "cache": hit, "saved": miss - hit,
            "improvement_pct": round(100 * (miss - hit) / miss)}


# -- Table 2 -----------------------------------------------------------------

def table2() -> Dict[str, Dict[str, Optional[float]]]:
    rows = {}
    for label, gb in [("1 GB", 1), ("50 GB", 50), ("100 GB", 100),
                      ("200 GB", 200), ("500 GB", 500), ("1 TB", 1024),
                      ("24 TB", 24 * 1024)]:
        rows[label] = {"hdfs": hdfs_capacity_files(gb),
                       "hopsfs": hopsfs_capacity_files(gb)}
    return rows


def capacity_headline() -> Dict[str, float]:
    """HopsFS stores 24x more metadata: NDB max cluster (48 dn x 512 GB =
    24 TB => 10.8 B files) vs HDFS practical max (200 GB JVM => ~0.45 B)."""
    ndb_total_gb = NDB_MAX_DATANODES * NDB_MAX_RAM_PER_NODE_GB
    hops = hopsfs_capacity_files(ndb_total_gb)
    hdfs = hdfs_capacity_files(200)
    assert hdfs is not None
    return {"hopsfs_files": hops, "hdfs_files": hdfs,
            "ratio": hops / hdfs}
