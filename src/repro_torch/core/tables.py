"""Fully-normalized metadata schema (paper §4.1, Figure 3).

Every entity from the paper's ER diagram is a table:

  inode      — one row per file/directory; PK = (parent_id, name);
               partition key = parent_id  (T2: all immediate children of a
               directory live on one shard -> `ls` is a partition-pruned scan)
  block      — file blocks; partition key = inode_id (file-related metadata
               co-located on one shard -> file read is partition-pruned)
  replica    — block replica locations; partition key = inode_id
  urb        — under-replicated blocks
  prb        — pending replication blocks
  ruc        — replicas under construction
  cr         — corrupted replicas
  er         — excess replicas
  inv        — invalidated replicas (scheduled for deletion)
  lease      — client leases (writers)
  lease_path — paths under lease
  quota      — directory quota + usage
  ongoing_subtree_ops — active subtree operations (paper §6.1 phase 1)
  leader     — leader-election / namenode membership rows (paper §3, [57])
  id_seq     — id allocation blocks

Rows are plain dicts. Tables carry schema metadata: primary-key columns,
partition-key column, and secondary indexes. ``IX_`` names below are the
canonical index identifiers used by scans and by cost accounting.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# Schema descriptors
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TableSchema:
    name: str
    pk: Tuple[str, ...]                 # primary-key columns (composite ok)
    partition_key: str                  # column whose hash picks the shard
    indexes: Tuple[str, ...] = ()       # secondary index columns (single col)
    # approximate on-NDB bytes per row (Table 2 capacity model; includes
    # replication=1 copy; indexes/keys/padding per the paper's `sizer` tool)
    row_bytes: int = 64


ROOT_ID = 1  # inode id of "/"; always cached by every namenode (paper §5.1)


def split_path(path: str) -> list:
    """Canonical path -> component list. THE one splitter, shared by
    server-side resolution (fs), client-side invalidation (hint_cache)
    and the planner — path normalization can never drift between them."""
    return [c for c in path.split("/") if c]

INODE = TableSchema(
    name="inode",
    pk=("parent_id", "name"),
    partition_key="parent_id",
    indexes=("id", "parent_id"),  # unique id index + children-of index
    row_bytes=296,
)
BLOCK = TableSchema("block", ("block_id",), "inode_id", ("inode_id",), 128)
REPLICA = TableSchema("replica", ("block_id", "datanode_id"), "inode_id",
                      ("inode_id", "datanode_id"), 96)
URB = TableSchema("urb", ("block_id",), "inode_id", ("inode_id",), 48)
PRB = TableSchema("prb", ("block_id",), "inode_id", ("inode_id",), 48)
RUC = TableSchema("ruc", ("block_id", "datanode_id"), "inode_id", ("inode_id",), 64)
CR = TableSchema("cr", ("block_id", "datanode_id"), "inode_id", ("inode_id",), 64)
ER = TableSchema("er", ("block_id", "datanode_id"), "inode_id", ("inode_id",), 64)
INV = TableSchema("inv", ("block_id", "datanode_id"), "inode_id", ("inode_id",), 64)
LEASE = TableSchema("lease", ("holder",), "holder", (), 80)
LEASE_PATH = TableSchema("lease_path", ("inode_id",), "holder", ("holder",), 96)
QUOTA = TableSchema("quota", ("inode_id",), "inode_id", (), 72)
SUBTREE_OPS = TableSchema("ongoing_subtree_ops", ("inode_id",), "inode_id",
                          ("namenode_id",), 64)
LEADER = TableSchema("leader", ("namenode_id",), "namenode_id", (), 64)
ID_SEQ = TableSchema("id_seq", ("seq_name",), "seq_name", (), 32)

ALL_TABLES: Tuple[TableSchema, ...] = (
    INODE, BLOCK, REPLICA, URB, PRB, RUC, CR, ER, INV,
    LEASE, LEASE_PATH, QUOTA, SUBTREE_OPS, LEADER, ID_SEQ,
)

# file-inode-related tables (partitioned by inode_id => co-located; paper §4.2)
FILE_RELATED = ("block", "replica", "urb", "prb", "ruc", "cr", "er", "inv")


# ---------------------------------------------------------------------------
# Row constructors
# ---------------------------------------------------------------------------

def make_inode(inode_id: int, parent_id: int, name: str, is_dir: bool, *,
               perm: int = 0o755, owner: str = "hops", group: str = "hops",
               size: int = 0, repl: int = 3, mtime: float = 0.0,
               client: Optional[str] = None) -> Dict[str, Any]:
    return {
        "id": inode_id,
        "parent_id": parent_id,
        "name": name,
        "is_dir": is_dir,
        "perm": perm,
        "owner": owner,
        "group": group,
        "size": size,
        "repl": repl,
        "mtime": mtime,
        "atime": mtime,
        # subtree-lock flag (paper §6.1 phase 1): None, or the id of the
        # namenode that owns the application-level lock on this subtree root.
        "subtree_lock": None,
        "under_construction": client is not None,
        "client": client,
    }


def make_block(block_id: int, inode_id: int, index: int, *,
               size: int = 0, gen_stamp: int = 0) -> Dict[str, Any]:
    return {"block_id": block_id, "inode_id": inode_id, "index": index,
            "size": size, "gen_stamp": gen_stamp, "state": "COMPLETE"}


def make_replica(block_id: int, inode_id: int, datanode_id: int) -> Dict[str, Any]:
    return {"block_id": block_id, "inode_id": inode_id,
            "datanode_id": datanode_id, "state": "FINALIZED"}


def pk_of(schema: TableSchema, row: Dict[str, Any]) -> Tuple[Any, ...]:
    return tuple(row[c] for c in schema.pk)


# ---------------------------------------------------------------------------
# Capacity model (paper §7.3, Table 2)
# ---------------------------------------------------------------------------

#: HDFS in-JVM bytes for a file with two blocks, 3x replicated: 448 + L
HDFS_FILE_BYTES_BASE = 448
#: HopsFS/NDB bytes for the same file at NDB replication 2 (measured with
#: the `sizer` tool in the paper): 2420 bytes.
HOPSFS_FILE_BYTES_R2 = 2420
#: NDB cluster limits used in the paper's Table 2
NDB_MAX_DATANODES = 48
NDB_MAX_RAM_PER_NODE_GB = 512


def hdfs_capacity_files(memory_gb: float, name_len: int = 10) -> Optional[float]:
    """Files storable in an HDFS namenode heap of ``memory_gb``.

    Returns None where HDFS "Does Not Scale" (the paper caps practical JVM
    heaps at ~200 GB due to GC pauses, §2.1/§7.3).
    """
    if memory_gb > 200:
        return None
    return memory_gb * (1 << 30) / (HDFS_FILE_BYTES_BASE + name_len)


def hopsfs_capacity_files(memory_gb: float) -> float:
    """Files storable in an NDB cluster with aggregate ``memory_gb`` RAM
    (replication 2 is already folded into HOPSFS_FILE_BYTES_R2)."""
    return memory_gb * (1 << 30) / HOPSFS_FILE_BYTES_R2
