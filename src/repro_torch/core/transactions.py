"""HopsFS transactional operations (paper §5, Figure 4).

A :class:`Transaction` implements the three-phase template:

  LOCK PHASE    — all data read up-front at the strongest lock level that the
                  op will ever need (prevents lock upgrades, §5 "Lock
                  Upgrades"), locks taken in total order (root-down DFS order
                  over paths, §5 "Cyclic Deadlocks"); batched PK reads and
                  partition-pruned index scans fill the per-transaction cache.
  EXECUTE PHASE — the FS op mutates rows *in the cache only*.
  UPDATE PHASE  — dirty rows are flushed to the store in batches, then the
                  transaction commits (locks released) or aborts (cache
                  dropped, locks released).

Every access path increments :class:`~repro_torch.core.store.OpCost`, giving the
measured round-trip profile that `benchmarks/bench_table3_costmodel.py`
checks against the paper's Table 3 formulas.

Distribution-aware transactions (§2.2): ``begin(partition_hint=...)`` places
the coordinator on the primary datanode of the hinted partition's node group.
Each subsequent round trip is classified local/remote against that node
group — this is what Fig 12/13's DAT ablation toggles.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .store import (EXCLUSIVE, READ_COMMITTED, SHARED, LockTimeout,
                    MetadataStore, OpCost, RowNotFound, Table,
                    TransactionAborted)
from .tables import pk_of

_TOMBSTONE = object()


class Transaction:
    def __init__(self, store: MetadataStore, *,
                 partition_hint: Optional[Tuple[str, Any]] = None,
                 distribution_aware: bool = True):
        self.store = store
        self.txn_id = store.next_txn_id()
        self.cost = OpCost()
        self.cache: Dict[Tuple[str, Tuple[Any, ...]], Any] = {}
        self.dirty: Set[Tuple[str, Tuple[Any, ...]]] = set()
        # per-table insertion-ordered view of the dirty PKs: the
        # read-your-writes scan overlay walks only ITS table's pending
        # rows, in deterministic (insertion) order, instead of re-sorting
        # the whole dirty set per scan — large grouped transactions (an
        # oversized lease-ordered block-write batch) would otherwise go
        # quadratic in scans over dirty keys
        self._dirty_order: Dict[str, List[Tuple[Any, ...]]] = {}
        # (table, indexed col) -> value -> insertion-ordered dirty PKs with
        # that value: the overlay's candidate set for ppis/index_scan. The
        # full _dirty_order walk made a grouped transaction interleaving
        # indexed scans with writes (G add_blocks over G distinct files,
        # each _file_scan probing `block` by inode_id) quadratic in G —
        # every scan walked EVERY dirty row of the table just to discard
        # the non-matching ones. Mirrors Table.idx, scoped to pending rows.
        self._dirty_idx: Dict[Tuple[str, str],
                              Dict[Any, List[Tuple[Any, ...]]]] = {}
        # last indexed values per dirty key, so re-writes can unindex
        self._dirty_vals: Dict[Tuple[str, Tuple[Any, ...]],
                               Dict[str, Any]] = {}
        #: overlay candidates examined across all scans this transaction —
        #: the counter the scan-scaling guard test asserts on (10x dirty
        #: rows must mean ~10x overlay work, not ~100x)
        self.overlay_scanned = 0
        self._done = False
        # --- distribution awareness (DAT) --------------------------------
        self.coordinator_group: Optional[int] = None
        if distribution_aware and partition_hint is not None:
            tname, pkey = partition_hint
            part = store.table(tname).partition_of(pkey)
            store.check_available(part)
            self.coordinator_group = store.group_of_partition(part).gid
        elif not distribution_aware:
            # round-robin coordinator: usually the wrong node group
            self.coordinator_group = self.txn_id % store.n_groups

    # ------------------------------------------------------------------
    # locality classification
    # ------------------------------------------------------------------
    def _charge_rt(self, parts: Iterable[int]) -> None:
        """Classify one round trip as local/remote wrt the coordinator."""
        parts = list(parts)
        if self.coordinator_group is None:
            self.cost.remote_rt += 1
            return
        groups = {self.store.group_of_partition(p).gid for p in parts}
        if groups and groups <= {self.coordinator_group}:
            self.cost.local_rt += 1
        else:
            self.cost.remote_rt += 1

    def _row_op(self, n: int = 1) -> None:
        self.cost.rows_touched += n
        self.store.total_row_ops += n

    # ------------------------------------------------------------------
    # LOCK/READ phase primitives
    # ------------------------------------------------------------------
    def read(self, tname: str, pk: Tuple[Any, ...], lock: str = READ_COMMITTED,
             *, _batched: bool = False) -> Optional[Dict[str, Any]]:
        """Single-row PK read at the given lock level. One round trip
        (unless part of a batch, which charges once at the batch)."""
        t = self.store.table(tname)
        part = t.partition_of_pk(pk)
        self.store.check_available(part)
        self.store.locks.acquire(self.txn_id, tname, pk, lock)
        if not _batched:
            if lock == READ_COMMITTED:
                self.cost.pk_rc += 1
            elif lock == SHARED:
                self.cost.pk_r += 1
            else:
                self.cost.pk_w += 1
            self._charge_rt([part])
        self._row_op()
        key = (tname, pk)
        if key in self.cache:
            v = self.cache[key]
            return None if v is _TOMBSTONE else v
        row = t.get(pk, part_hint=part)
        if row is not None:
            row = dict(row)  # snapshot into txn cache
            self.cache[key] = row
        return row

    def peek(self, tname: str, pk: Tuple[Any, ...]
             ) -> Optional[Dict[str, Any]]:
        """Read a row through the transaction's own cache WITHOUT charging a
        round trip. Rows already read (lock phase) or written (execute
        phase) this transaction are served from the cache — which is what
        makes grouped write transactions see each other's in-flight updates
        (e.g. two creates in one directory accumulating the parent's quota)
        — and anything else falls through to the raw store row, matching
        the direct-store peeks the sequential write path has always done."""
        key = (tname, pk)
        if key in self.cache:
            v = self.cache[key]
            return None if v is _TOMBSTONE else v
        return self.store.table(tname).get(pk)

    def read_batch(self, reads: Sequence[Tuple[str, Tuple[Any, ...], str]]
                   ) -> List[Optional[Dict[str, Any]]]:
        """Batched PK reads: one round trip for the whole batch (§5.1).
        ``reads`` is a list of (table, pk, lock_mode)."""
        if not reads:
            return []
        out = []
        parts = []
        for tname, pk, lock in reads:
            t = self.store.table(tname)
            parts.append(t.partition_of_pk(pk))
            out.append(self.read(tname, pk, lock, _batched=True))
        self.cost.batches += 1
        self.cost.batch_rows += len(reads)
        self._charge_rt(parts)
        return out

    def batch(self) -> "_BatchCtx":
        """Context manager grouping several PK reads into ONE round trip,
        allowing later reads' keys to depend on earlier reads' values (the
        DAL builds such dependent batches; the network charge is one
        exchange). Usage::

            with txn.batch() as b:
                row = b.read("inode", pk, EXCLUSIVE)
                b.read("lease", (row["client"],), READ_COMMITTED)
        """
        return _BatchCtx(self)

    def ppis(self, tname: str, index_col: str, value: Any,
             lock: str = READ_COMMITTED, *,
             projection: Optional[Sequence[str]] = None
             ) -> List[Dict[str, Any]]:
        """Partition-pruned index scan: the index column IS the partition
        key (or co-partitioned with it), so exactly one shard is touched."""
        t = self.store.table(tname)
        part = t.partition_of(value)
        self.store.check_available(part)
        rows = t.scan_index(index_col, value)
        self.cost.ppis += 1
        self._charge_rt([part])
        return self._absorb_scan(tname, t, rows, lock, projection,
                                 match=lambda r: r.get(index_col) == value,
                                 index_key=(index_col, value))

    def index_scan(self, tname: str, index_col: str, value: Any,
                   lock: str = READ_COMMITTED) -> List[Dict[str, Any]]:
        """Index scan that cannot be pruned: hits every shard (cost IS)."""
        t = self.store.table(tname)
        rows = t.scan_index(index_col, value)
        self.cost.is_scans += 1
        self._charge_rt(range(t.n_partitions))
        return self._absorb_scan(tname, t, rows, lock, None,
                                 match=lambda r: r.get(index_col) == value,
                                 index_key=(index_col, value))

    def full_scan(self, tname: str, pred: Callable[[Dict[str, Any]], bool]
                  ) -> List[Dict[str, Any]]:
        t = self.store.table(tname)
        rows = t.scan_all(pred)
        self.cost.fts += 1
        self._charge_rt(range(t.n_partitions))
        return self._absorb_scan(tname, t, rows, READ_COMMITTED, None,
                                 match=pred)

    def scan_partition_pruned_pred(self, tname: str, pkey_value: Any,
                                   pred: Callable[[Dict[str, Any]], bool],
                                   lock: str = READ_COMMITTED
                                   ) -> List[Dict[str, Any]]:
        """PPIS variant with an arbitrary predicate evaluated on one shard
        (used by subtree quiescing, §6.1 phase 2)."""
        t = self.store.table(tname)
        part = t.partition_of(pkey_value)
        self.store.check_available(part)
        rows = t.scan_partition(part, pred)
        self.cost.ppis += 1
        self._charge_rt([part])
        return self._absorb_scan(
            tname, t, rows, lock, None,
            match=lambda r: (t.partition_of(r[t.schema.partition_key])
                             == part and pred(r)))

    def _absorb_scan(self, tname: str, t: Table, rows, lock, projection,
                     match: Optional[Callable[[Dict[str, Any]], bool]]
                     = None,
                     index_key: Optional[Tuple[str, Any]] = None):
        out = []
        seen: Set[Tuple[Any, ...]] = set()
        for row in rows:
            pk = pk_of(t.schema, row)
            seen.add(pk)
            self.store.locks.acquire(self.txn_id, tname, pk, lock)
            self._row_op()
            key = (tname, pk)
            if key in self.cache:
                v = self.cache[key]
                if v is _TOMBSTONE:
                    continue
                out.append(v)
                continue
            snap = dict(row)
            if projection is None:
                self.cache[key] = snap
            out.append({c: snap[c] for c in projection} if projection else snap)
        # Read-your-writes overlay: rows INSERTED by this transaction are
        # not in the store yet, so the store scan above cannot return them
        # — but the real engine's scans see the transaction's own pending
        # rows. Grouped write transactions rely on this: two add_blocks on
        # one file in the same group must each see the other's block row
        # exactly as committed sequential transactions would.
        if match is not None and self.dirty:
            # indexed scans walk only the dirty rows that CAN match (the
            # per-(table, col, value) candidate list); predicate scans
            # still walk the table's whole dirty set. Candidates are
            # re-checked against `match` either way, so a stale index
            # entry can only cost a wasted probe, never a wrong row.
            if index_key is not None \
                    and index_key[0] in t.schema.indexes:
                col, value = index_key
                candidates: Iterable[Tuple[Any, ...]] = \
                    self._dirty_idx.get((tname, col), {}).get(value, ())
            else:
                candidates = self._dirty_order.get(tname, ())
            for pk in candidates:
                self.overlay_scanned += 1
                if pk in seen:
                    continue
                v = self.cache[(tname, pk)]
                if v is _TOMBSTONE or not match(v):
                    continue
                self.store.locks.acquire(self.txn_id, tname, pk, lock)
                self._row_op()
                out.append({c: v[c] for c in projection}
                           if projection else v)
        return out

    # ------------------------------------------------------------------
    # EXECUTE phase: cache mutation
    # ------------------------------------------------------------------
    def _mark_dirty(self, tname: str, pk: Tuple[Any, ...]) -> None:
        key = (tname, pk)
        if key not in self.dirty:
            self.dirty.add(key)
            self._dirty_order.setdefault(tname, []).append(pk)

    def _reindex_dirty(self, tname: str, t: Table, pk: Tuple[Any, ...],
                       row: Optional[Dict[str, Any]]) -> None:
        """Keep the dirty-row secondary index in step with the txn cache
        (``row=None`` on delete): unhook the key from its previous indexed
        values, hook it under the new ones."""
        if not t.schema.indexes:
            return
        key = (tname, pk)
        old = self._dirty_vals.get(key)
        new = ({c: row.get(c) for c in t.schema.indexes}
               if row is not None else None)
        for c in t.schema.indexes:
            ov = old.get(c) if old is not None else None
            nv = new.get(c) if new is not None else None
            if old is not None and (new is None or ov != nv):
                lst = self._dirty_idx.get((tname, c), {}).get(ov)
                if lst is not None:
                    try:
                        lst.remove(pk)
                    except ValueError:
                        pass
            if new is not None and (old is None or ov != nv):
                self._dirty_idx.setdefault((tname, c), {}) \
                    .setdefault(nv, []).append(pk)
        if new is None:
            self._dirty_vals.pop(key, None)
        else:
            self._dirty_vals[key] = new

    def write(self, tname: str, row: Dict[str, Any]) -> None:
        """Insert/update a row in the txn cache (flushed at commit). The row
        lock must already be held exclusively if the row pre-existed."""
        t = self.store.table(tname)
        pk = pk_of(t.schema, row)
        self.store.locks.acquire(self.txn_id, tname, pk, EXCLUSIVE)
        self.cache[(tname, pk)] = row
        self._mark_dirty(tname, pk)
        self._reindex_dirty(tname, t, pk, row)

    def delete(self, tname: str, pk: Tuple[Any, ...]) -> None:
        self.store.locks.acquire(self.txn_id, tname, pk, EXCLUSIVE)
        self.cache[(tname, pk)] = _TOMBSTONE
        self._mark_dirty(tname, pk)
        self._reindex_dirty(tname, self.store.table(tname), pk, None)

    # ------------------------------------------------------------------
    # UPDATE phase
    # ------------------------------------------------------------------
    def commit(self, *, batch_size: int = 1024) -> OpCost:
        """Flush dirty rows in batches (each batch = 1 write round trip,
        counted as PK_w per Table 3's convention of per-row write ops when
        rows are few, or as batches when large — we count one PK_w per dirty
        row up to 8 rows, then batched), then release locks."""
        if self._done:
            raise TransactionAborted("transaction already finished")
        try:
            dirty = sorted(self.dirty)
            if dirty:
                parts_touched = []
                for tname, pk in dirty:
                    t = self.store.table(tname)
                    v = self.cache[(tname, pk)]
                    if v is _TOMBSTONE:
                        t.delete(pk)
                    else:
                        t.put(dict(v))
                    self._row_op()
                    parts_touched.append(t.partition_of_pk(pk))
                if len(dirty) <= 8:
                    self.cost.pk_w += len(dirty)
                    for p in parts_touched:
                        self._charge_rt([p])
                else:
                    nb = (len(dirty) + batch_size - 1) // batch_size
                    self.cost.batches += nb
                    self.cost.batch_rows += len(dirty)
                    for _ in range(nb):
                        self._charge_rt(parts_touched)
            return self.cost
        finally:
            self._finish()

    def abort(self) -> None:
        if not self._done:
            self._finish()

    def _finish(self) -> None:
        self._done = True
        self.store.locks.release_all(self.txn_id)

    # context manager: commit on success, abort on exception
    def __enter__(self) -> "Transaction":
        return self

    def __exit__(self, et, ev, tb) -> bool:
        if et is None:
            if not self._done:
                self.commit()
        else:
            self.abort()
        return False


class _BatchCtx:
    def __init__(self, txn: Transaction):
        self.txn = txn
        self.parts: List[int] = []
        self.rows = 0

    def read(self, tname: str, pk: Tuple[Any, ...],
             lock: str = READ_COMMITTED) -> Optional[Dict[str, Any]]:
        t = self.txn.store.table(tname)
        self.parts.append(t.partition_of_pk(pk))
        self.rows += 1
        return self.txn.read(tname, pk, lock, _batched=True)

    def __enter__(self) -> "_BatchCtx":
        return self

    def __exit__(self, et, ev, tb) -> bool:
        if et is None and self.rows:
            self.txn.cost.batches += 1
            self.txn.cost.batch_rows += self.rows
            self.txn._charge_rt(self.parts)
        return False


def run_with_retry(fn: Callable[[], Any], *, retries: int = 3,
                   backoff: float = 0.005) -> Any:
    """Namenode-side retry loop: lock timeouts and aborted transactions are
    retried (paper §7.5: failed transactions automatically retried on a
    different database node)."""
    last: Optional[Exception] = None
    for attempt in range(retries + 1):
        try:
            return fn()
        except (LockTimeout, TransactionAborted) as e:  # pragma: no cover
            last = e
            time.sleep(backoff * (2 ** attempt))
    raise last  # type: ignore[misc]
