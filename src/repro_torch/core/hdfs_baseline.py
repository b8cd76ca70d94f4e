"""Apache HDFS baseline (paper §2.1) — the system HopsFS is compared against.

A faithful functional model of the HDFS v2.x namenode architecture:

  * the whole namespace lives in one process' memory (dict-based, like the
    JVM heap object graph);
  * a **single global readers-writer lock** serializes metadata operations
    (single-writer / multiple-readers semantics);
  * high availability = Active NN + Standby NN + quorum journal: edits are
    logged to 2f+1 journal nodes; the standby tails the log and checkpoints;
    failover requires the standby to catch up + fencing via ZooKeeper —
    modelled as a downtime window proportional to untailed edits (§7.6.1:
    8-10 s in the paper's small-metadata tests; minutes at Spotify scale);
  * large deletes are executed in multiple phases and are NOT atomic (§2.1);
  * memory cost per file: 448 + len(name) bytes (Table 2).

The functional layer is used by correctness tests; the DES
(`cluster_sim.py`) layers queueing/timing on top for Figs 6-11.

The baseline is host-only: it holds no tensors, launches no kernel and has
no ``device``, as HDFS's namenode is one JVM heap.  It is carried across
from the JAX package as it is, faults included (``mkdir`` never checks that
an existing component is a directory).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

from .tables import HDFS_FILE_BYTES_BASE


class HDFSError(Exception):
    pass


class _RWLock:
    """Single global namespace lock: single writer, multiple readers."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._readers = 0
        self._rcond = threading.Condition(self._mu)

    def acquire_read(self):
        with self._mu:
            self._readers += 1

    def release_read(self):
        with self._mu:
            self._readers -= 1
            self._rcond.notify_all()

    def acquire_write(self):
        self._mu.acquire()
        while self._readers:
            self._rcond.wait()
        # hold _mu as the write lock

    def release_write(self):
        self._mu.release()


@dataclass
class _INode:
    id: int
    name: str
    is_dir: bool
    perm: int = 0o755
    owner: str = "hdfs"
    size: int = 0
    blocks: List[int] = field(default_factory=list)
    children: Dict[str, "_INode"] = field(default_factory=dict)


class HDFSNamenode:
    """Functional single-namenode HDFS."""

    READ_OPS = {"read", "ls", "stat", "content_summary"}

    def __init__(self) -> None:
        self.root = _INode(1, "", True)
        self.lock = _RWLock()
        self._next_id = 2
        self._next_blk = 1
        self.n_files = 0
        self.n_dirs = 1
        self.edits_logged = 0          # journal length since last checkpoint
        self.block_map: Dict[int, List[int]] = {}

    # -- path helpers (recursive in-heap resolution) --------------------
    def _walk(self, path: str, *, parent: bool = False) -> _INode:
        comps = [c for c in path.split("/") if c]
        if parent:
            comps = comps[:-1]
        node = self.root
        for c in comps:
            nxt = node.children.get(c)
            if nxt is None:
                raise HDFSError(f"not found: {path}")
            node = nxt
        return node

    # -- operations ------------------------------------------------------
    def mkdir(self, path: str) -> int:
        self.lock.acquire_write()
        try:
            comps = [c for c in path.split("/") if c]
            node = self.root
            for c in comps:
                if c not in node.children:
                    node.children[c] = _INode(self._next_id, c, True)
                    self._next_id += 1
                    self.n_dirs += 1
                    self.edits_logged += 1
                node = node.children[c]
            return node.id
        finally:
            self.lock.release_write()

    def create(self, path: str) -> int:
        self.lock.acquire_write()
        try:
            parent = self._walk(path, parent=True)
            name = path.rstrip("/").rsplit("/", 1)[-1]
            if name in parent.children:
                raise HDFSError(f"exists: {path}")
            f = _INode(self._next_id, name, False)
            self._next_id += 1
            parent.children[name] = f
            self.n_files += 1
            self.edits_logged += 1
            return f.id
        finally:
            self.lock.release_write()

    def add_block(self, path: str) -> int:
        self.lock.acquire_write()
        try:
            f = self._walk(path)
            bid = self._next_blk
            self._next_blk += 1
            f.blocks.append(bid)
            self.block_map[bid] = [0, 1, 2]
            self.edits_logged += 1
            return bid
        finally:
            self.lock.release_write()

    def read(self, path: str) -> List[Tuple[int, List[int]]]:
        self.lock.acquire_read()
        try:
            f = self._walk(path)
            return [(b, self.block_map.get(b, [])) for b in f.blocks]
        finally:
            self.lock.release_read()

    def ls(self, path: str) -> List[str]:
        self.lock.acquire_read()
        try:
            return sorted(self._walk(path).children.keys())
        finally:
            self.lock.release_read()

    def stat(self, path: str) -> Dict[str, Any]:
        self.lock.acquire_read()
        try:
            n = self._walk(path)
            return {"id": n.id, "is_dir": n.is_dir, "perm": n.perm,
                    "owner": n.owner, "size": n.size}
        finally:
            self.lock.release_read()

    def chmod(self, path: str, perm: int) -> None:
        """In-heap subtree ops are fast: everything is local (Fig 6/7)."""
        self.lock.acquire_write()
        try:
            def rec(n: _INode):
                n.perm = perm
                for c in n.children.values():
                    rec(c)
            rec(self._walk(path))
            self.edits_logged += 1
        finally:
            self.lock.release_write()

    def rename(self, src: str, dst: str) -> None:
        self.lock.acquire_write()
        try:
            sp = self._walk(src, parent=True)
            name = src.rstrip("/").rsplit("/", 1)[-1]
            node = sp.children.pop(name)
            dp = self._walk(dst, parent=True)
            dname = dst.rstrip("/").rsplit("/", 1)[-1]
            node.name = dname
            dp.children[dname] = node
            self.edits_logged += 1
        finally:
            self.lock.release_write()

    def delete(self, path: str) -> int:
        """Large deletes happen in phases and are not atomic (§2.1): inodes
        first, then blocks in small batches (we count both phases)."""
        self.lock.acquire_write()
        try:
            parent = self._walk(path, parent=True)
            name = path.rstrip("/").rsplit("/", 1)[-1]
            node = parent.children.pop(name)
        finally:
            self.lock.release_write()
        # phase 2+: incremental block deletion outside the big lock
        removed = 0

        def rec(n: _INode) -> int:
            cnt = 1
            for b in n.blocks:
                self.block_map.pop(b, None)
            for c in list(n.children.values()):
                cnt += rec(c)
            return cnt
        removed = rec(node)
        self.edits_logged += removed
        return removed

    # -- capacity (Table 2) ------------------------------------------------
    def metadata_bytes(self, avg_name_len: int = 10) -> int:
        return (self.n_files + self.n_dirs) * \
            (HDFS_FILE_BYTES_BASE + avg_name_len)


@dataclass
class HDFSHACluster:
    """ANN + SbNN + journal quorum + ZooKeeper (Fig 1, 5-8 servers).

    Failover model (§7.6.1): ZK detects failure after `detect_s`; the standby
    must replay untailed edits (`replay_rate` edits/s) and assume active
    duty. During that window *no* metadata op can be served.
    """
    n_journal: int = 3
    detect_s: float = 2.0
    replay_rate: float = 50_000.0
    standby_lag_edits: int = 300_000   # checkpoint lag at failure time

    def __post_init__(self) -> None:
        self.active = HDFSNamenode()
        self.journal_alive = self.n_journal

    def failover_downtime_s(self) -> float:
        return self.detect_s + self.standby_lag_edits / self.replay_rate

    def journal_quorum_ok(self) -> bool:
        return self.journal_alive > self.n_journal // 2

    def fail_journal_node(self) -> None:
        self.journal_alive -= 1
        if not self.journal_quorum_ok():
            raise HDFSError("journal quorum lost: namenode shuts down")
