"""Shared-nothing, partitioned, transactional in-memory store (paper §2.2).

This is the NDB-equivalent storage engine: tables are hash-partitioned on an
application-defined partition key (ADP, §4.2) across a fixed set of
partitions; partitions are assigned to *node groups* of ``replication``
datanodes each (§2.2.1). Transaction coordinators live on every datanode;
a transaction started with a *partition hint* runs its coordinator on the
primary datanode of that partition's node group (DAT, §2.2) so that reads of
co-located rows are node-local.

Access-path cost hierarchy (paper Fig 2a), tracked per-transaction by
:class:`OpCost`:

    PK read  <  batched PK read  <  partition-pruned index scan (PPIS)
             <<  index scan (IS, hits all shards)  <  full table scan (FTS)

Isolation: read-committed plus explicit row locks (shared / exclusive),
exactly the primitives NDB exposes (§2.2.2). Lock waits block (thread mode)
with timeout-abort; HopsFS-level deadlock freedom comes from total-order
acquisition in the FS layer (§5, "Cyclic Deadlocks").
"""
from __future__ import annotations

import threading
import time
import zlib
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

from ..device import resolve_device
from .tables import ALL_TABLES, TableSchema, pk_of

# ---------------------------------------------------------------------------
# Errors
# ---------------------------------------------------------------------------


class StoreError(Exception):
    pass


class RowNotFound(StoreError):
    pass


class LockTimeout(StoreError):
    """Raised when a row lock cannot be acquired within the transaction
    inactive timeout (paper §7.5: NDB default 1.2 s; retried by namenode)."""


class TransactionAborted(StoreError):
    pass


class NodeGroupDown(StoreError):
    """All replicas of a node group failed => cluster unavailable (§7.6.2)."""


class NetworkPartition(StoreError):
    """The client could not reach the namenode (the namenode itself may be
    perfectly alive).  Raised by the chaos injector on partitioned
    exchanges; the ``failover`` middleware treats it as retryable on
    another namenode (§7.6.1 — to the client, an unreachable namenode and
    a dead one are indistinguishable)."""


# ---------------------------------------------------------------------------
# Lock manager
# ---------------------------------------------------------------------------

READ_COMMITTED = "rc"
SHARED = "S"
EXCLUSIVE = "X"


class _RowLock:
    __slots__ = ("holders", "mode", "cond", "waiters")

    def __init__(self, cond_factory):
        self.holders: Set[int] = set()
        self.mode: Optional[str] = None
        self.cond = cond_factory()
        self.waiters = 0          # threads blocked in acquire() on this row


_LockKey = Tuple[str, Tuple[Any, ...]]


class LockManager:
    """Row-level shared/exclusive locks keyed by (table, pk), striped.

    The lock table is sharded into ``n_stripes`` independently-mutexed
    stripes (like NDB's LQH lock fragments), so unrelated rows never
    contend on one global mutex — the concurrent request pipeline runs one
    thread per namenode against this table. A per-transaction held-locks
    index makes :meth:`release_all` O(locks held by the txn) instead of
    O(all locks currently held cluster-wide).
    """

    def __init__(self, timeout: float = 1.2, n_stripes: int = 64):
        self.timeout = timeout
        self.n_stripes = max(1, n_stripes)
        self._mus = [threading.Lock() for _ in range(self.n_stripes)]
        self._locks: List[Dict[_LockKey, _RowLock]] = [
            {} for _ in range(self.n_stripes)]
        # txn_id -> keys it holds; guarded by its own (O(1)-hold) mutex
        self._held_mu = threading.Lock()
        self._held: Dict[int, Set[_LockKey]] = {}
        #: cumulative contention telemetry: every non-READ_COMMITTED
        #: acquire counts once; acquires that found a conflicting holder
        #: (and therefore waited — possibly timing out) count once more.
        #: wait_count/acquire_count is the LOCK-WAIT FRACTION the elastic
        #: pool samples and the WindowController's batch-size knob feeds
        #: on. Best-effort under concurrency (plain ints), exact on the
        #: deterministic pipelines.
        self.acquire_count = 0
        self.wait_count = 0

    def _stripe(self, key: _LockKey) -> int:
        return hash(key) % self.n_stripes

    def acquire(self, txn_id: int, table: str, pk: Tuple[Any, ...],
                mode: str) -> None:
        if mode == READ_COMMITTED:
            return
        key = (table, pk)
        s = self._stripe(key)
        mu = self._mus[s]
        with mu:
            lk = self._locks[s].get(key)
            if lk is None:
                lk = self._locks[s][key] = _RowLock(
                    lambda: threading.Condition(mu))
            # deadline computed once, outside the wait loop (hot path)
            deadline = time.monotonic() + self.timeout
            lk.waiters += 1
            self.acquire_count += 1
            waited = False
            try:
                while True:
                    if not lk.holders or lk.holders == {txn_id}:
                        break
                    if mode == SHARED and lk.mode == SHARED:
                        break
                    if not waited:
                        waited = True
                        self.wait_count += 1
                    # conflicting: wait (bounded by NDB txn-inactive timeout)
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not lk.cond.wait(remaining):
                        raise LockTimeout(
                            f"lock timeout on {table}{pk} ({mode})")
            except LockTimeout:
                lk.waiters -= 1
                if not lk.holders and not lk.waiters:
                    del self._locks[s][key]   # entry we created, now orphaned
                raise
            else:
                lk.waiters -= 1
            lk.holders.add(txn_id)
            if lk.mode == EXCLUSIVE or mode == EXCLUSIVE:
                lk.mode = EXCLUSIVE
            else:
                lk.mode = SHARED
        with self._held_mu:
            self._held.setdefault(txn_id, set()).add(key)

    def release_all(self, txn_id: int) -> None:
        with self._held_mu:
            keys = self._held.pop(txn_id, None)
        if not keys:
            return
        by_stripe: Dict[int, List[_LockKey]] = {}
        for key in keys:
            by_stripe.setdefault(self._stripe(key), []).append(key)
        for s, stripe_keys in by_stripe.items():
            with self._mus[s]:
                locks = self._locks[s]
                for key in stripe_keys:
                    lk = locks.get(key)
                    if lk is None or txn_id not in lk.holders:
                        continue
                    lk.holders.discard(txn_id)
                    if not lk.holders:
                        lk.mode = None
                    lk.cond.notify_all()
                    # reclaim the entry only when nobody still waits on its
                    # condition — a waiter woken after the entry was dropped
                    # would otherwise mutate an orphaned lock object
                    if not lk.holders and not lk.waiters:
                        del locks[key]

    def held(self, table: str, pk: Tuple[Any, ...]) -> Optional[str]:
        key = (table, pk)
        with self._mus[self._stripe(key)]:
            lk = self._locks[self._stripe(key)].get(key)
            return lk.mode if lk and lk.holders else None

    def held_count(self, txn_id: int) -> int:
        """Number of row locks the transaction currently holds (the index
        the O(held) release walks)."""
        with self._held_mu:
            return len(self._held.get(txn_id, ()))


# ---------------------------------------------------------------------------
# Op-cost accounting (Fig 2a + Table 3 round-trip model)
# ---------------------------------------------------------------------------


@dataclass
class OpCost:
    """Round trips + row ops for one transaction, in Table 3's vocabulary.

    One *round trip* is one network exchange between the namenode's DAL and
    the database: a single PK op, one batch (regardless of rows inside), one
    PPIS, one IS (which fans out to every shard but is still one client
    round trip with higher cost weight), or one FTS.
    """
    pk_rc: int = 0        # PK read, read-committed (no lock)
    pk_r: int = 0         # PK read, shared lock
    pk_w: int = 0         # PK read-for-update / write, exclusive lock
    batches: int = 0      # batched PK operations
    batch_rows: int = 0   # total rows across batches
    ppis: int = 0         # partition-pruned index scans
    is_scans: int = 0     # index scans hitting all shards
    fts: int = 0          # full table scans
    # locality: round trips answered by the hinted (coordinator-local)
    # node group vs remote node groups (DAT effectiveness, §7.7)
    local_rt: int = 0
    remote_rt: int = 0
    rows_touched: int = 0

    @property
    def round_trips(self) -> int:
        return (self.pk_rc + self.pk_r + self.pk_w + self.batches
                + self.ppis + self.is_scans + self.fts)

    _FIELDS = ("pk_rc", "pk_r", "pk_w", "batches", "batch_rows", "ppis",
               "is_scans", "fts", "local_rt", "remote_rt", "rows_touched")

    def copy(self) -> "OpCost":
        return OpCost(**{f: getattr(self, f) for f in self._FIELDS})

    def diff(self, earlier: "OpCost") -> "OpCost":
        """Cost accrued since the `earlier` snapshot (batched pipeline uses
        this to attribute per-op shares of a shared transaction)."""
        return OpCost(**{f: getattr(self, f) - getattr(earlier, f)
                         for f in self._FIELDS})

    def merge(self, other: "OpCost") -> None:
        for f in self._FIELDS:
            setattr(self, f, getattr(self, f) + getattr(other, f))

    def as_dict(self) -> Dict[str, int]:
        d = {f: getattr(self, f) for f in self._FIELDS}
        d["round_trips"] = self.round_trips
        return d


# ---------------------------------------------------------------------------
# Partitioned table
# ---------------------------------------------------------------------------


def _hash_key(value: Any) -> int:
    """Deterministic partition hash (NDB uses MD5 of the partition key; we
    use crc32 of the repr — stable across runs, cheap, well-mixed for ids)."""
    if isinstance(value, int):
        # avoid trivial modulo patterns on sequential ids
        v = value * 0x9E3779B1 & 0xFFFFFFFF
        return v ^ (v >> 16)
    return zlib.crc32(repr(value).encode())


class Table:
    def __init__(self, schema: TableSchema, n_partitions: int):
        self.schema = schema
        self.n_partitions = n_partitions
        self.parts: List[Dict[Tuple[Any, ...], Dict[str, Any]]] = [
            {} for _ in range(n_partitions)]
        # secondary indexes: col -> value -> set of pks
        self.idx: Dict[str, Dict[Any, Set[Tuple[Any, ...]]]] = {
            c: {} for c in schema.indexes}
        self.n_rows = 0
        # pk -> partition, maintained only for tables whose partition key
        # is NOT part of the PK (block/replica/...): NDB resolves such PKs
        # through its distribution hash; here an O(1) map replaces the
        # all-partition search on get/delete and detects partition-key
        # updates on put
        self._pk_loc: Optional[Dict[Tuple[Any, ...], int]] = (
            None if schema.partition_key in schema.pk else {})

    # -- placement -----------------------------------------------------
    def partition_of(self, partition_key_value: Any) -> int:
        return _hash_key(partition_key_value) % self.n_partitions

    def partition_of_pk(self, pk: Tuple[Any, ...]) -> int:
        # partition key is always a PK column prefix or derivable from a row;
        # for PKs we locate via the partition-key column position if it is in
        # the PK, else via the pk-location map.
        s = self.schema
        if s.partition_key in s.pk:
            return self.partition_of(pk[s.pk.index(s.partition_key)])
        p = self._pk_loc.get(pk)  # type: ignore[union-attr]
        return p if p is not None else self.partition_of(pk)

    # -- row ops (no locking here; engine layer handles locks/costs) ----
    def get(self, pk: Tuple[Any, ...], part_hint: Optional[int] = None
            ) -> Optional[Dict[str, Any]]:
        if part_hint is not None:
            return self.parts[part_hint].get(pk)
        return self.parts[self.partition_of_pk(pk)].get(pk)

    def put(self, row: Dict[str, Any]) -> None:
        pk = pk_of(self.schema, row)
        p = self.partition_of(row[self.schema.partition_key])
        part = self.parts[p]
        old = part.get(pk)
        if old is not None:
            self._unindex(old, pk)
        elif self._pk_loc is not None:
            # A partition-key UPDATE (e.g. concat re-owning block/replica
            # rows to the target file's inode id) moves the row between
            # shards — NDB performs an internal delete+insert.  Evict the
            # copy on the old shard so the PK stays unique cluster-wide.
            old_p = self._pk_loc.get(pk)
            if old_p is not None and old_p != p:
                old = self.parts[old_p].pop(pk, None)
                if old is not None:
                    self._unindex(old, pk)
        if old is None:
            self.n_rows += 1
        part[pk] = row
        if self._pk_loc is not None:
            self._pk_loc[pk] = p
        self._index(row, pk)

    def delete(self, pk: Tuple[Any, ...]) -> bool:
        p = self.partition_of_pk(pk)
        row = self.parts[p].pop(pk, None)
        if self._pk_loc is not None:
            self._pk_loc.pop(pk, None)
        if row is None:
            return False
        self._unindex(row, pk)
        self.n_rows -= 1
        return True

    def _index(self, row, pk):
        for c, ix in self.idx.items():
            ix.setdefault(row[c], set()).add(pk)

    def _unindex(self, row, pk):
        for c, ix in self.idx.items():
            s = ix.get(row[c])
            if s is not None:
                s.discard(pk)
                if not s:
                    del ix[row[c]]

    # -- scans ----------------------------------------------------------
    def scan_index(self, col: str, value: Any) -> List[Dict[str, Any]]:
        pks = self.idx.get(col, {}).get(value, ())
        out = []
        for pk in pks:
            r = self.get(pk)
            if r is not None:
                out.append(r)
        return out

    def scan_partition(self, part: int, pred: Callable[[Dict[str, Any]], bool]
                       ) -> List[Dict[str, Any]]:
        return [r for r in self.parts[part].values() if pred(r)]

    def scan_all(self, pred: Callable[[Dict[str, Any]], bool]
                 ) -> List[Dict[str, Any]]:
        out = []
        for part in self.parts:
            out.extend(r for r in part.values() if pred(r))
        return out


# ---------------------------------------------------------------------------
# Node groups / cluster topology (paper §2.2.1)
# ---------------------------------------------------------------------------


@dataclass
class NodeGroup:
    gid: int
    datanodes: List[int]
    alive: Set[int] = field(default_factory=set)

    def available(self) -> bool:
        return bool(self.alive)


class MetadataStore:
    """The NDB-equivalent cluster: tables + partitions + node groups + locks.

    ``n_datanodes`` NDB datanodes, ``replication`` copies per node group
    (default 2 as in the paper). Partition ``p`` of every table lives on node
    group ``p % n_groups``; the *primary* replica rotates by partition for
    balance. Failing a datanode keeps the store available while its node
    group has a survivor; failing an entire node group raises
    :class:`NodeGroupDown` on access (paper §7.6.2: "namenodes shutdown").

    ``device`` is where the request path's kernels run for this store: the
    card by default (raising when there is none), the plain PyTorch
    versions on the host only for ``device="cpu"``.
    """

    def __init__(self, n_datanodes: int = 4, replication: int = 2,
                 n_partitions: int = 64, lock_timeout: float = 1.2,
                 device: Any = None):
        self.device = resolve_device(device)
        if n_datanodes % replication:
            raise ValueError("n_datanodes must be a multiple of replication")
        self.n_datanodes = n_datanodes
        self.replication = replication
        self.n_groups = n_datanodes // replication
        self.node_groups = [
            NodeGroup(g, list(range(g * replication, (g + 1) * replication)),
                      set(range(g * replication, (g + 1) * replication)))
            for g in range(self.n_groups)]
        self.n_partitions = n_partitions
        self.tables: Dict[str, Table] = {
            s.name: Table(s, n_partitions) for s in ALL_TABLES}
        self.locks = LockManager(timeout=lock_timeout)
        self._txn_seq = 0
        self._mu = threading.Lock()
        self.epoch = 0            # global checkpoint epoch (§2.2.1)
        self.total_row_ops = 0    # lifetime row ops (DES capacity feed)
        # cross-client hint invalidation push (the store-level analogue of
        # NDB's event API the real HopsFS uses for cache invalidation):
        # every destructive op bumps hint_epoch and logs the invalidated
        # paths; namenodes piggyback the epoch plus the recent log tail on
        # EVERY response, so clients that never saw the destructive op
        # still drop their stale InodeHintCache entries
        self.hint_epoch = 0
        self._hint_log: deque = deque(maxlen=self.HINT_LOG_MAX)
        self._hint_mu = threading.Lock()
        self._hint_pb: Tuple[int, Tuple] = (0, ())   # memoized piggyback

    #: bounded invalidation log: epochs older than hint_epoch-HINT_LOG_TAIL
    #: are no longer piggybacked — a client that far behind clears its
    #: cache wholesale instead of replaying individual invalidations
    HINT_LOG_MAX = 64
    HINT_LOG_TAIL = 8

    # -- cross-client hint invalidation (epoch push) ---------------------
    def record_hint_invalidation(self, paths) -> int:
        """One destructive op committed: bump the hint epoch and log its
        invalidated paths (one epoch per op, every path tagged with it).
        Returns the new epoch."""
        with self._hint_mu:
            self.hint_epoch += 1
            e = self.hint_epoch
            for p in paths:
                if p:
                    self._hint_log.append((e, str(p)))
            return e

    def hint_piggyback(self) -> Tuple:
        """The tagged entries every response appends to ``OpResult.hints``:
        a ``(-1, "", epoch)`` marker carrying the store's current hint
        epoch, then one ``(-1, path, epoch)`` entry per recently
        invalidated path (epochs within :data:`HINT_LOG_TAIL` of current).
        Empty while no destructive op has ever run — read-only workloads
        pay nothing. Memoized per epoch: the hot path is one lock-free
        tuple reuse."""
        cur = self.hint_epoch
        if cur == 0:
            return ()
        memo_epoch, memo = self._hint_pb
        if memo_epoch == cur:
            return memo
        with self._hint_mu:
            cur = self.hint_epoch
            floor = cur - self.HINT_LOG_TAIL
            out = ((-1, "", cur),) + tuple(
                (-1, p, e) for e, p in self._hint_log if e > floor)
            self._hint_pb = (cur, out)
            return out

    # -- topology --------------------------------------------------------
    def group_of_partition(self, part: int) -> NodeGroup:
        return self.node_groups[part % self.n_groups]

    def primary_datanode(self, part: int) -> int:
        g = self.group_of_partition(part)
        if not g.alive:
            raise NodeGroupDown(f"node group {g.gid} has no live datanode")
        # rotate primary across partitions for balance
        members = [d for d in g.datanodes if d in g.alive]
        return members[(part // self.n_groups) % len(members)]

    def fail_datanode(self, dn: int) -> None:
        for g in self.node_groups:
            g.alive.discard(dn)

    def recover_datanode(self, dn: int) -> None:
        for g in self.node_groups:
            if dn in g.datanodes:
                g.alive.add(dn)

    def available(self) -> bool:
        return all(g.available() for g in self.node_groups)

    def check_available(self, part: int) -> None:
        g = self.group_of_partition(part)
        if not g.available():
            raise NodeGroupDown(f"node group {g.gid} down")

    # -- transactions ------------------------------------------------------
    def next_txn_id(self) -> int:
        with self._mu:
            self._txn_seq += 1
            return self._txn_seq

    # -- memory accounting (Table 2) ---------------------------------------
    def memory_bytes(self) -> int:
        total = 0
        for t in self.tables.values():
            total += t.n_rows * t.schema.row_bytes * self.replication
        return total

    def table(self, name: str) -> Table:
        return self.tables[name]

    # -- introspection ------------------------------------------------------
    def dump_state(self, *, exclude_cols: Sequence[str] = ()
                   ) -> Dict[str, List[Tuple[Any, Any]]]:
        """Deterministic snapshot of every table (rows sorted by PK).

        Used by the batched-pipeline tests to assert that batched execution
        leaves the store in exactly the state sequential execution does.
        ``exclude_cols`` drops columns that legitimately differ between runs
        with different namenode counts (e.g. per-namenode mtime clocks)."""
        ex = set(exclude_cols)
        out: Dict[str, List[Tuple[Any, Any]]] = {}
        for name, t in self.tables.items():
            rows = []
            for part in t.parts:
                for pk, row in part.items():
                    rows.append((pk, tuple(sorted(
                        (k, v) for k, v in row.items() if k not in ex))))
            out[name] = sorted(rows, key=lambda r: repr(r[0]))
        return out
