"""Columnar struct-of-arrays metadata engine (HopsFS §4.2 partitioned
tables, re-laid-out for batch validation).

The dict-backed :class:`~repro_torch.core.store.Table` stores one Python
dict per row, sharded over partition dicts.  This module keeps the exact
same ``MetadataStore``/``Table`` interface but lays hot tables (inode,
block, lease) out column-major: every column is one flat array/list indexed
by a row *slot*, integer id columns and the per-row partition assignment
are mirrored into flat numpy arrays, and the inode table's composite PK
``(parent_id, name)`` is additionally maintained in an open-addressing
:class:`HashIndex`, whose arrays have a mirror on the store's device that
the CUDA kernels read:

* ``repro_torch.kernels.pkval`` — grouped-batch PK validation: ONE launch
  checks a whole planner window's client-resolved ``(parent_id, name)``
  chains against the store's hash index, demoting stale hints to the
  sequential path before they waste a batched round trip;
* ``repro_torch.kernels.hintchain`` — vectorized hint-chain resolution:
  ONE launch walks every op's cached parent chain against snapshots of the
  client + namenode hint caches, replacing the per-probe Python loop in
  ``lower_trace``;
* ``repro_torch.kernels.treeagg`` — subtree wave expansion: ONE launch
  over the inode table's hot columns (mirrored on the device as well)
  resolves a whole BFS wave's children and their count/dir/size sums, for
  the subtree protocol's phase 2 and for ``du``.

pkval and hintchain are ADVISORY: their output only picks which ops ride
the batched fast path vs the exact sequential path, and every shipped hint
is still validated against real rows inside the server transaction.  The
dict store therefore remains the always-on oracle: outcomes and the
logical namespace always agree with it, and ``dump_state`` is byte-equal
while pkval demotes no chain (a demoted op may run on another namenode,
which draws other ids).  Which implementation runs depends only on the
store's device — the kernel on CUDA, the plain PyTorch version on the CPU
— and a kernel error is raised, never hidden.

Sentinel encoding shared by the host index and both kernels::

    parent slot  -1  EMPTY      ends a linear-probe chain
    parent slot  -2  TOMBSTONE  probe continues through it
    value        -3  AMBIG      crc32-collided bucket: cannot be trusted,
                                the host must re-resolve exactly
"""
from __future__ import annotations

import threading
from typing import (Any, Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Set, Tuple)

import numpy as np
import torch

from ..kernels._staging import upload_i32
from .store import MetadataStore
from .tables import ROOT_ID, TableSchema, pk_of
from .ops_registry import REGISTRY
from .workload import ColumnarTrace, WorkloadOp, lower_trace, name_hash32

# sentinels — MUST match repro_torch.kernels.pkval (asserted by the
# kernel tests so the two can never drift silently)
EMPTY = -1
TOMB = -2
AMBIG = -3
#: linear-probe bound shared with the kernels: the host index GROWS
#: rather than ever placing an entry more than MAX_PROBE slots from home,
#: so a kernel miss after MAX_PROBE steps is a real miss.
MAX_PROBE = 8

_GOLDEN = 0x9E3779B1
_GOLDEN2 = 0x85EBCA6B

#: below this many probes the scalar Python walk is used instead of a
#: kernel launch (the same gates as the JAX package: whether pkval runs
#: decides demotions, so equal gates keep every count equal)
PKVAL_MIN_BATCH = 128
HINTCHAIN_MIN_BATCH = 128
#: treeagg gates on the inode table's SLOT count (the kernel sweeps every
#: slot per launch), so tiny namespaces stay on the Python path entirely
TREEAGG_MIN_BATCH = 128

_MISSING = object()          # column sentinel: row has no such key


# ---------------------------------------------------------------------------
# open-addressing (parent_id, name_hash32) -> inode id index
# ---------------------------------------------------------------------------


class HashIndex:
    """Flat open-addressing hash table over composite PKs, kernel-ready.

    Keys are ``(parent_id, crc32(name))``; values are inode ids.  The
    three backing arrays (``par`` int32, ``nam`` uint32, ``val`` int32)
    are exactly what ``pkval``/``hintchain`` consume — :meth:`arrays`
    hands them over with zero copying.  The bucket mix is the kernels'
    ``_bucket_hash`` bit-for-bit; capacity is always a power of two and
    the index grows whenever an insert cannot land within ``MAX_PROBE``
    slots of home (or load passes 1/2), so device probes and host probes
    always agree.

    A bucket whose 32-bit key collides across DIFFERENT names under the
    same parent is poisoned with the value ``AMBIG`` — the kernels pass
    it through and the caller re-resolves those probes exactly.

    The host arrays stay the authority for inserts and removals (the
    probe-bound growth logic is host code).  :meth:`device_arrays` keeps a
    mirror of them on a device: the slots written since the last call are
    copied over, and after a growth the whole index is.  One lock orders
    writes against refreshes, since concurrent namenodes commit and
    validate from several threads.
    """

    def __init__(self, cap: int = 64):
        if cap & (cap - 1):
            raise ValueError("capacity must be a power of two")
        self.cap = cap
        self.par = np.full(cap, EMPTY, np.int32)
        self.nam = np.zeros(cap, np.uint32)
        self.val = np.full(cap, EMPTY, np.int32)
        self.used = 0            # live + tombstones (probe-chain occupancy)
        self.live = 0
        self._mirror: Optional[torch.Tensor] = None     # [3, cap]
        self._rows: Tuple[torch.Tensor, ...] = ()       # its three rows
        self._mirror_device: Optional[torch.device] = None
        self._dirty: List[int] = []   # slots written since the last refresh
        self._mu = threading.RLock()

    @staticmethod
    def _mix(par: int, nam: int) -> int:
        """Host mirror of the kernels' uint32 bucket mix."""
        h = ((par * _GOLDEN) & 0xFFFFFFFF) ^ ((nam * _GOLDEN2) & 0xFFFFFFFF)
        return (h ^ (h >> 16)) & 0xFFFFFFFF

    def _find(self, par: int, nam: int
              ) -> Tuple[Optional[int], Optional[int]]:
        """(slot holding the key or None, first insertable slot or None),
        scanning at most MAX_PROBE slots from home — the device bound."""
        home = self._mix(par & 0xFFFFFFFF, nam) & (self.cap - 1)
        ins: Optional[int] = None
        for step in range(MAX_PROBE):
            j = (home + step) & (self.cap - 1)
            p = int(self.par[j])
            if p == EMPTY:
                return None, (j if ins is None else ins)
            if p == TOMB:
                if ins is None:
                    ins = j
                continue
            if p == par and int(self.nam[j]) == nam:
                return j, ins
        return None, ins

    def set(self, par: int, nam: int, value: int) -> None:
        with self._mu:
            self._set(par, nam, value)

    def _set(self, par: int, nam: int, value: int) -> None:
        j, ins = self._find(par, nam)
        if j is not None:
            self.val[j] = value
            if self._mirror is not None:
                self._dirty.append(j)
            return
        if ins is None or 2 * (self.used + 1) > self.cap:
            self._grow()
            self._set(par, nam, value)
            return
        if int(self.par[ins]) == EMPTY:
            self.used += 1
        self.par[ins] = par
        self.nam[ins] = nam
        self.val[ins] = value
        self.live += 1
        if self._mirror is not None:
            self._dirty.append(ins)

    def remove(self, par: int, nam: int) -> bool:
        with self._mu:
            j, _ = self._find(par, nam)
            if j is None:
                return False
            self.par[j] = TOMB
            self.nam[j] = 0
            self.val[j] = EMPTY
            self.live -= 1
            if self._mirror is not None:
                self._dirty.append(j)
            return True

    def get(self, par: int, nam: int) -> int:
        """Resolved id, EMPTY on miss — may return AMBIG for a poisoned
        bucket, exactly like the kernels."""
        j, _ = self._find(par, nam)
        return int(self.val[j]) if j is not None else EMPTY

    def _grow(self) -> None:
        entries = [(int(p), int(m), int(v))
                   for p, m, v in zip(self.par, self.nam, self.val)
                   if int(p) >= 0]
        cap = self.cap
        while True:
            cap *= 2
            par = np.full(cap, EMPTY, np.int32)
            nam = np.zeros(cap, np.uint32)
            val = np.full(cap, EMPTY, np.int32)
            ok = True
            for p, m, v in entries:
                home = self._mix(p & 0xFFFFFFFF, m) & (cap - 1)
                for step in range(MAX_PROBE):
                    j = (home + step) & (cap - 1)
                    if int(par[j]) == EMPTY:
                        par[j] = p
                        nam[j] = m
                        val[j] = v
                        break
                else:
                    ok = False       # chain still too long — double again
                    break
            if ok:
                self.cap = cap
                self.par, self.nam, self.val = par, nam, val
                self.used = self.live = len(entries)
                self._mirror = None          # copied whole at next use
                self._dirty = []
                return

    def arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The host (parent, name_hash, value) triple — views, not copies."""
        return self.par, self.nam, self.val

    def device_arrays(self, device: Any
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The (parent, name_hash, value) triple as int32 tensors on
        ``device`` (name hashes as bit patterns), equal to the host arrays:
        the first call and the first after a growth copy the whole index,
        later ones only the slots written in between: the slots (int64, as
        pairs of int32 words) and their three values in one packed upload,
        then one ``index_copy_`` into the mirror, one [3, C] tensor whose
        rows are the triple."""
        device = torch.device(device)
        with self._mu:
            host = (self.par, self.nam.view(np.int32), self.val)
            if self._mirror is None or self._mirror_device != device:
                self._dirty = []
                self._mirror_device = device
                self._mirror = torch.empty((3, self.cap), dtype=torch.int32,
                                           device=device)
                self._rows = tuple(self._mirror)
                for row, a in zip(self._rows, host):
                    row.copy_(torch.from_numpy(a))
            elif self._dirty:
                idx = np.unique(np.asarray(self._dirty, np.int64))
                self._dirty = []
                at, vals = upload_i32(
                    [idx.view(np.int32), np.stack([a[idx] for a in host])],
                    device)
                self._mirror.index_copy_(1, at.view(torch.int64), vals)
            return self._rows

    @classmethod
    def from_entries(cls, entries: Iterable[Tuple[int, str, int]]
                     ) -> "HashIndex":
        """Build from ``(parent_id, name, inode_id)`` triples (hint-cache
        ``export_entries`` order = oldest first, so later duplicates win
        exactly like the cache's own overwrite), poisoning crc32-collided
        buckets with AMBIG."""
        idx = cls()
        seen: Dict[Tuple[int, int], str] = {}
        ambig: Set[Tuple[int, int]] = set()
        for par, name, iid in entries:
            h = name_hash32(name)
            key = (par, h)
            if key in ambig:
                continue
            prev = seen.get(key)
            if prev is None or prev == name:
                seen[key] = name
                idx.set(par, h, iid)
            else:
                ambig.add(key)
                idx.set(par, h, AMBIG)
        return idx


# ---------------------------------------------------------------------------
# columnar table
# ---------------------------------------------------------------------------

#: integer columns mirrored into flat numpy arrays per table (ids and
#: parent pointers — what scans, joins and kernels actually consume)
HOT_INT_COLS: Dict[str, Tuple[str, ...]] = {
    "inode": ("id", "parent_id", "size", "is_dir"),
    "block": ("block_id", "inode_id"),
    "lease": (),
}


class ColumnarTable:
    """Struct-of-arrays drop-in for :class:`repro_torch.core.store.Table`.

    Rows live in per-column arrays indexed by an integer *slot*:
    ``_cols[col][slot]`` holds the exact Python value (``_MISSING`` where
    a row lacks the key, so heterogeneous rows round-trip byte-exact),
    ``part_slots[slot]`` the row's partition, and the ``HOT_INT_COLS``
    are mirrored into flat ``int64`` arrays.  ``_slots`` maps PK ->
    slot in insertion order, which makes every scan reproduce the dict
    store's iteration order (per-partition insertion order; partition-key
    relocation moves the row to the end of its new shard, exactly like
    the dict store's pop+reinsert).

    The inode table additionally maintains :attr:`hindex`, the
    open-addressing ``(parent_id, crc32(name)) -> id`` index the pkval
    kernel probes; crc-collided buckets are tracked per key and poisoned
    with ``AMBIG``.  Its hot columns have a device mirror for the treeagg
    kernel (:meth:`device_columns`), kept like the index's: slots written
    since the last use are copied over, the whole mirror after a growth.

    Interface parity with ``Table`` (schema/n_partitions/parts/idx/
    n_rows/_pk_loc/partition_of/partition_of_pk/get/put/delete/
    scan_index/scan_partition/scan_all) is what lets the transaction
    engine, namenodes and ``dump_state`` run unchanged on either backend.
    """

    def __init__(self, schema: TableSchema, n_partitions: int):
        self.schema = schema
        self.n_partitions = n_partitions
        self.idx: Dict[str, Dict[Any, Set[Tuple[Any, ...]]]] = {
            c: {} for c in schema.indexes}
        self.n_rows = 0
        self._pk_loc: Optional[Dict[Tuple[Any, ...], int]] = (
            None if schema.partition_key in schema.pk else {})
        self._cap = 16
        self._top = 0
        self._free: List[int] = []
        self._slots: Dict[Tuple[Any, ...], int] = {}
        self._cols: Dict[str, List[Any]] = {}
        self.part_slots = np.full(self._cap, -1, np.int64)
        self._hot: Dict[str, np.ndarray] = {
            c: np.full(self._cap, -1, np.int64)
            for c in HOT_INT_COLS.get(schema.name, ())}
        if schema.name == "inode":
            self.hindex: Optional[HashIndex] = HashIndex()
            self._namehash = np.zeros(self._cap, np.uint32)
            # (parent, crc32(name)) -> {pk: id}: crc collision tracker
            # that keeps hindex's AMBIG poisoning exact under churn
            self._hkey: Dict[Tuple[int, int], Dict[Tuple[Any, ...], int]] = {}
        else:
            self.hindex = None
        # device mirror of the hot columns (device_columns); one lock
        # orders hot-column writes against refreshes, since concurrent
        # namenodes commit from several threads
        self._mirror: Optional[Dict[str, torch.Tensor]] = None
        self._mirror_device: Optional[torch.device] = None
        self._dirty: List[int] = []   # slots written since the last refresh
        self._mu = threading.RLock()

    # -- slot management -----------------------------------------------
    def _alloc(self) -> int:
        if self._free:
            return self._free.pop()
        if self._top == self._cap:
            with self._mu:
                self._grow_slots()
        slot = self._top
        self._top += 1
        return slot

    def _grow_slots(self) -> None:
        new_cap = self._cap * 2
        grown = np.full(new_cap, -1, np.int64)
        grown[:self._cap] = self.part_slots
        self.part_slots = grown
        for c, arr in self._hot.items():
            g = np.full(new_cap, -1, np.int64)
            g[:self._cap] = arr
            self._hot[c] = g
        if self.hindex is not None:
            g = np.zeros(new_cap, np.uint32)
            g[:self._cap] = self._namehash
            self._namehash = g
        for col in self._cols.values():
            col.extend([_MISSING] * self._cap)
        self._cap = new_cap
        self._mirror = None              # copied whole at next use
        self._dirty = []

    def _store_row(self, slot: int, row: Dict[str, Any]) -> None:
        for col in self._cols.values():
            col[slot] = _MISSING
        for k, v in row.items():
            col = self._cols.get(k)
            if col is None:
                col = [_MISSING] * self._cap
                self._cols[k] = col
            col[slot] = v
        with self._mu:
            for c, arr in self._hot.items():
                v = row.get(c)
                arr[slot] = int(v) if isinstance(v, (int, np.integer)) else -1
            if self._mirror is not None:
                self._dirty.append(slot)
        if self.hindex is not None:
            self._namehash[slot] = name_hash32(row["name"])

    def _materialize(self, slot: int) -> Dict[str, Any]:
        return {k: col[slot] for k, col in self._cols.items()
                if col[slot] is not _MISSING}

    def _clear_slot(self, slot: int) -> None:
        for col in self._cols.values():
            col[slot] = _MISSING
        with self._mu:
            for arr in self._hot.values():
                arr[slot] = -1
            if self._mirror is not None:
                self._dirty.append(slot)

    # -- inode PK hash-index maintenance --------------------------------
    def _hash_sync(self, key: Tuple[int, int]) -> None:
        assert self.hindex is not None
        d = self._hkey.get(key)
        if not d:
            self._hkey.pop(key, None)
            self.hindex.remove(key[0], key[1])
        elif len(d) == 1:
            self.hindex.set(key[0], key[1], next(iter(d.values())))
        else:
            self.hindex.set(key[0], key[1], AMBIG)

    def _hash_add(self, pk: Tuple[Any, ...], row: Dict[str, Any]) -> None:
        key = (int(row["parent_id"]), name_hash32(row["name"]))
        self._hkey.setdefault(key, {})[pk] = int(row["id"])
        self._hash_sync(key)

    def _hash_remove(self, pk: Tuple[Any, ...], row: Dict[str, Any]) -> None:
        key = (int(row["parent_id"]), name_hash32(row["name"]))
        d = self._hkey.get(key)
        if d is not None:
            d.pop(pk, None)
            self._hash_sync(key)

    # -- placement (identical to Table) ---------------------------------
    def partition_of(self, partition_key_value: Any) -> int:
        from .store import _hash_key
        return _hash_key(partition_key_value) % self.n_partitions

    def partition_of_pk(self, pk: Tuple[Any, ...]) -> int:
        s = self.schema
        if s.partition_key in s.pk:
            return self.partition_of(pk[s.pk.index(s.partition_key)])
        p = self._pk_loc.get(pk)  # type: ignore[union-attr]
        return p if p is not None else self.partition_of(pk)

    # -- row ops ---------------------------------------------------------
    def get(self, pk: Tuple[Any, ...], part_hint: Optional[int] = None
            ) -> Optional[Dict[str, Any]]:
        slot = self._slots.get(pk)
        if slot is None:
            return None
        if part_hint is not None and int(self.part_slots[slot]) != part_hint:
            return None          # wrong-shard probe misses, like the dict store
        return self._materialize(slot)

    def put(self, row: Dict[str, Any]) -> None:
        pk = pk_of(self.schema, row)
        p = self.partition_of(row[self.schema.partition_key])
        slot = self._slots.get(pk)
        if slot is None:
            slot = self._alloc()
            self._slots[pk] = slot
            self.n_rows += 1
        else:
            old = self._materialize(slot)
            self._unindex(old, pk)
            if self.hindex is not None:
                self._hash_remove(pk, old)
            if int(self.part_slots[slot]) != p:
                # partition-key UPDATE = NDB-internal delete+insert; the
                # dict store reinserts at the end of the new shard, so
                # move the slot to the end of insertion order too
                self._slots.pop(pk)
                self._slots[pk] = slot
        self.part_slots[slot] = p
        self._store_row(slot, row)
        if self._pk_loc is not None:
            self._pk_loc[pk] = p
        self._index(row, pk)
        if self.hindex is not None:
            self._hash_add(pk, row)

    def delete(self, pk: Tuple[Any, ...]) -> bool:
        slot = self._slots.pop(pk, None)
        if self._pk_loc is not None:
            self._pk_loc.pop(pk, None)
        if slot is None:
            return False
        row = self._materialize(slot)
        self._unindex(row, pk)
        if self.hindex is not None:
            self._hash_remove(pk, row)
        self._clear_slot(slot)
        self.part_slots[slot] = -1
        self._free.append(slot)
        self.n_rows -= 1
        return True

    def _index(self, row: Dict[str, Any], pk: Tuple[Any, ...]) -> None:
        for c, ix in self.idx.items():
            ix.setdefault(row[c], set()).add(pk)

    def _unindex(self, row: Dict[str, Any], pk: Tuple[Any, ...]) -> None:
        for c, ix in self.idx.items():
            s = ix.get(row[c])
            if s is not None:
                s.discard(pk)
                if not s:
                    del ix[row[c]]

    # -- scans -----------------------------------------------------------
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
        out = []
        for pk, slot in self._slots.items():
            if int(self.part_slots[slot]) == part:
                r = self._materialize(slot)
                if pred(r):
                    out.append(r)
        return out

    def scan_all(self, pred: Callable[[Dict[str, Any]], bool]
                 ) -> List[Dict[str, Any]]:
        # partition-major like the dict store: bucket one insertion-order
        # pass, then flatten in partition order
        buckets: List[List[Dict[str, Any]]] = [
            [] for _ in range(self.n_partitions)]
        for pk, slot in self._slots.items():
            r = self._materialize(slot)
            if pred(r):
                buckets[int(self.part_slots[slot])].append(r)
        out: List[Dict[str, Any]] = []
        for b in buckets:
            out.extend(b)
        return out

    # -- dict-store-compatible views --------------------------------------
    @property
    def parts(self) -> List[Dict[Tuple[Any, ...], Dict[str, Any]]]:
        """Materialized per-partition row dicts — the read-only iteration
        view ``dump_state``/``namespace_snapshot`` consume."""
        out: List[Dict[Tuple[Any, ...], Dict[str, Any]]] = [
            {} for _ in range(self.n_partitions)]
        for pk, slot in self._slots.items():
            out[int(self.part_slots[slot])][pk] = self._materialize(slot)
        return out

    def hot_column(self, col: str) -> np.ndarray:
        """The live int64 mirror of a hot id column (slots, -1 = empty)."""
        return self._hot[col][:self._top]

    @staticmethod
    def _for_device(col: str, a: np.ndarray) -> np.ndarray:
        """A hot column as the treeagg kernel takes it: ids stay int64;
        parents int32; is_dir and size int32, with cleared slots' -1 as 0
        (parents and sizes cut to their low 32 bits, as the JAX package
        casts them)."""
        if col == "id":
            return a
        if col == "parent_id":
            return a.astype(np.int32)
        return np.maximum(a, 0).astype(np.int32)

    def device_columns(self, device: Any) -> Dict[str, torch.Tensor]:
        """The hot columns' slots in use, as tensors on ``device``
        (:meth:`_for_device` types), equal to the host columns: the first
        call and the first after a growth copy them whole, later ones only
        the slots written in between (``index_copy_``)."""
        device = torch.device(device)
        with self._mu:
            if self._mirror is None or self._mirror_device != device:
                self._dirty = []
                self._mirror_device = device
                self._mirror = {
                    c: torch.from_numpy(self._for_device(c, a)).to(
                        device, copy=True) for c, a in self._hot.items()}
            elif self._dirty:
                idx = np.unique(np.asarray(self._dirty, np.int64))
                self._dirty = []
                at = torch.from_numpy(idx).to(device)
                for c, m in self._mirror.items():
                    m.index_copy_(0, at, torch.from_numpy(
                        self._for_device(c, self._hot[c][idx])).to(device))
            top = self._top
            return {c: m[:top] for c, m in self._mirror.items()}


class ColumnarMetadataStore(MetadataStore):
    """`MetadataStore` with the hot tables swapped to :class:`ColumnarTable`.

    Constructed exactly like the dict store (same partitioning, node
    groups, locks, hint-epoch piggyback) — only the storage layout of
    inode/block/lease changes, which is what the differential harness
    relies on: any behavioural drift IS a bug, not a feature."""

    COLUMNAR_TABLES = ("inode", "block", "lease")

    def __init__(self, *args: Any, **kwargs: Any):
        super().__init__(*args, **kwargs)
        for name in self.COLUMNAR_TABLES:
            t = self.tables.get(name)
            if t is not None:
                self.tables[name] = ColumnarTable(t.schema,
                                                  self.n_partitions)


# ---------------------------------------------------------------------------
# fused hint-chain window lowering (hintchain kernel launch site)
# ---------------------------------------------------------------------------


def _lower_one(ct: ColumnarTrace, i: int, wop: WorkloadOp, spec: Any,
               comps: List[str], resolver: Any) -> None:
    """Per-op body of ``workload.lower_trace``, verbatim — the exact path
    the fused reconstruction falls back to for AMBIG buckets."""
    need_leaf = spec.batchable or (spec.group_mutable
                                   and spec.hint == "target")
    pks: List[Tuple[int, str]] = []
    parent = ROOT_ID
    target_id: Optional[int] = None
    ok = True
    for d, name in enumerate(comps):
        pks.append((parent, name))
        ct.parent_ids[i, d] = parent
        ct.name_hashes[i, d] = name_hash32(name)
        child = resolver.peek(parent, name)
        if child is None:
            if d < len(comps) - 1 or need_leaf:
                ok = False
            break
        parent = child
        if d == len(comps) - 1:
            target_id = child
    ct.depths[i] = len(pks)
    if not ok:
        ct.resolved.append(False)
        ct.pks.append(None)
        ct.target_ids.append(None)
        return
    if spec.hint == "parent":
        ct.hint_ids[i] = pks[-1][0]
    else:
        ct.hint_ids[i] = target_id if target_id is not None else parent
    ct.resolved.append(True)
    ct.pks.append(tuple(pks))
    ct.target_ids.append(target_id)


def _snapshot_resolver(cache: Any, fallback: Any
                       ) -> Optional[Tuple[HashIndex, HashIndex]]:
    """Hash-index snapshots of (client cache, merged namenode caches);
    None when a view cannot be represented (unknown resolver shape)."""
    if not hasattr(cache, "export_entries"):
        return None
    cidx = HashIndex.from_entries(cache.export_entries())
    if fallback is None:
        fidx = HashIndex()
    elif hasattr(fallback, "caches"):
        # MultiCacheResolver precedence: first cache that knows a key wins
        merged: Dict[Tuple[int, str], int] = {}
        for c in fallback.caches:
            if not hasattr(c, "export_entries"):
                return None
            for par, name, iid in c.export_entries():
                merged.setdefault((par, name), iid)
        fidx = HashIndex.from_entries(
            (par, name, iid) for (par, name), iid in merged.items())
    elif hasattr(fallback, "export_entries"):
        fidx = HashIndex.from_entries(fallback.export_entries())
    else:
        return None
    return cidx, fidx


def lower_trace_fused(wops: Sequence[WorkloadOp], resolver: Any, *,
                      device: Any, max_depth: int = 16,
                      min_batch: Optional[int] = None
                      ) -> Tuple[ColumnarTrace, bool]:
    """``workload.lower_trace`` with the per-probe Python loop replaced by
    ONE ``hintchain`` launch on ``device`` over the whole window.

    Returns ``(trace, used_kernel)``.  Bit-equivalent to the Python walk:
    the resolver's hit/fallback/miss telemetry is replayed from the
    kernel's per-depth source codes, and any op that touches a
    crc-collided (AMBIG) bucket is re-resolved through the exact per-probe
    path.  Windows below ``min_batch`` total probes and resolvers that are
    not a ``HintResolver`` shape take the pure walk."""
    if min_batch is None:
        min_batch = HINTCHAIN_MIN_BATCH      # runtime lookup: patchable
    cache = getattr(resolver, "cache", None)
    fallback = getattr(resolver, "fallback", None)
    if cache is None or not all(hasattr(resolver, a) for a in
                                ("hits", "fallback_hits", "misses")):
        return lower_trace(wops, resolver, max_depth=max_depth), False
    n = len(wops)
    comps_of: List[Optional[List[str]]] = []
    specs: List[Any] = []
    total = 0
    for wop in wops:
        spec = REGISTRY.get(wop.op)
        comps = [c for c in wop.path.split("/") if c]
        specs.append(spec)
        if spec is None or not comps or len(comps) > max_depth:
            comps_of.append(None)
        else:
            comps_of.append(comps)
            total += len(comps)
    if total < max(2, min_batch):
        return lower_trace(wops, resolver, max_depth=max_depth), False
    snap = _snapshot_resolver(cache, fallback)
    if snap is None:
        return lower_trace(wops, resolver, max_depth=max_depth), False
    cidx, fidx = snap
    nam = np.zeros((n, max_depth), np.uint32)
    dep = np.zeros(n, np.int32)
    for i, comps in enumerate(comps_of):
        if comps:
            dep[i] = len(comps)
            nam[i, :len(comps)] = [name_hash32(c) for c in comps]

    from ..kernels.hintchain.ops import hintchain_resolve
    childs, srcs = hintchain_resolve(cidx.arrays(), fidx.arrays(), nam, dep,
                                     device=device, root_id=ROOT_ID)

    type_names = list(REGISTRY.names())
    type_of = {name: i for i, name in enumerate(type_names)}
    type_ids = np.zeros(n, np.int32)
    depths = np.zeros(n, np.int32)
    parent_ids = np.zeros((n, max_depth), np.int64)
    name_hashes = np.zeros((n, max_depth), np.int64)
    hint_ids = np.full(n, ROOT_ID, np.int64)
    ct = ColumnarTrace(n=n, max_depth=max_depth, type_ids=type_ids,
                       depths=depths, parent_ids=parent_ids,
                       name_hashes=name_hashes, hint_ids=hint_ids)
    for i, wop in enumerate(wops):
        spec = specs[i]
        type_ids[i] = type_of.get(wop.op, -1)
        comps = comps_of[i]
        if comps is None:
            ct.resolved.append(False)
            ct.pks.append(None)
            ct.target_ids.append(None)
            continue
        need_leaf = spec.batchable or (spec.group_mutable
                                       and spec.hint == "target")
        pks: List[Tuple[int, str]] = []
        parent = ROOT_ID
        target_id: Optional[int] = None
        ok = True
        redo = False
        for d, name in enumerate(comps):
            pks.append((parent, name))
            parent_ids[i, d] = parent
            name_hashes[i, d] = name_hash32(name)
            child = int(childs[i, d])
            if child <= 0 and child != EMPTY:
                redo = True     # AMBIG bucket (or out-of-protocol code):
                break           # re-resolve this op exactly
            if child == EMPTY:
                resolver.misses += 1
                if d < len(comps) - 1 or need_leaf:
                    ok = False
                break
            if int(srcs[i, d]) == 0:
                resolver.hits += 1
            else:
                resolver.fallback_hits += 1
            parent = child
            if d == len(comps) - 1:
                target_id = child
        if redo:
            parent_ids[i, :] = 0
            name_hashes[i, :] = 0
            _lower_one(ct, i, wop, spec, comps, resolver)
            continue
        depths[i] = len(pks)
        if not ok:
            ct.resolved.append(False)
            ct.pks.append(None)
            ct.target_ids.append(None)
            continue
        if spec.hint == "parent":
            hint_ids[i] = pks[-1][0]
        else:
            hint_ids[i] = target_id if target_id is not None else parent
        ct.resolved.append(True)
        ct.pks.append(tuple(pks))
        ct.target_ids.append(target_id)
    return ct, True


# ---------------------------------------------------------------------------
# grouped-batch PK validation (pkval kernel launch site)
# ---------------------------------------------------------------------------


def _chain_probes(chains: Sequence[Tuple[Sequence[Tuple[int, str]],
                                         Optional[int]]]
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[int]]:
    """Flatten resolved ``(pks, target_id)`` chains into parallel probe
    arrays: each link's composite PK plus the inode id the client believes
    it resolves to (the next link's parent; the target for the leaf)."""
    parents: List[int] = []
    nams: List[int] = []
    expect: List[int] = []
    owner: List[int] = []
    for k, (pks, target_id) in enumerate(chains):
        if not pks:
            continue
        for d, (par, name) in enumerate(pks):
            if d < len(pks) - 1:
                want = pks[d + 1][0]
            elif target_id is not None:
                want = target_id
            else:
                continue        # parent-hinted leaf: nothing was resolved
            parents.append(par)
            nams.append(name_hash32(name))
            expect.append(want)
            owner.append(k)
    return (np.asarray(parents, np.int64), np.asarray(nams, np.int64),
            np.asarray(expect, np.int64), owner)


def _validate_chains(hindex: HashIndex,
                     chains: Sequence[Tuple[Sequence[Tuple[int, str]],
                                            Optional[int]]],
                     *, min_batch: int, device: Any
                     ) -> Tuple[Set[int], int, bool]:
    """(chain indices whose client resolution disagrees with the store,
    probe count, used_kernel). AMBIG buckets are inconclusive — the chain
    is KEPT and the server-side in-transaction validation decides."""
    parents, nams, expect, owner = _chain_probes(chains)
    # below the gate, skip validation ENTIRELY: small windows then behave
    # bit-identically to the dict backend
    if len(parents) < max(2, min_batch):
        return set(), 0, False
    from ..kernels.pkval.ops import pkval_lookup
    tp, tn, tv = hindex.device_arrays(device)
    out = pkval_lookup(tp, tn, tv, parents, nams)
    demoted: Set[int] = set()
    for i, k in enumerate(owner):
        got = int(out[i])
        if got == AMBIG:
            continue
        if got != int(expect[i]):
            demoted.add(k)
    return demoted, len(parents), True


def validate_window_pks(store: MetadataStore, ct: ColumnarTrace, *,
                        min_batch: Optional[int] = None
                        ) -> Optional[Tuple[Set[int], int, bool]]:
    """Grouped-batch PK validation of a planner window (§5.1 batched
    reads, validated BEFORE they ship): every client-resolved chain in
    ``ct`` is probed against the columnar inode hash index in one fused
    launch.  Returns ``(demoted op indices, probes, used_kernel)``, or
    None when the store has no columnar inode table (the dict oracle) —
    validation is purely advisory, so the dict backend simply skips it.

    A demoted op is NOT failed: the planner clears its resolution so it
    rides the exact sequential path, with the outcome and the logical
    namespace it would have had.  Its physical state may differ from the
    dict store's: the sequential path may run the op on another namenode,
    which draws inode and block ids from its own allocator block and
    stamps mtimes from its own clock."""
    if min_batch is None:
        min_batch = PKVAL_MIN_BATCH          # runtime lookup: patchable
    try:
        t = store.table("inode")
    except Exception:
        return None
    hindex = getattr(t, "hindex", None)
    if hindex is None:
        return None
    chains: List[Tuple[Sequence[Tuple[int, str]], Optional[int]]] = []
    owners: List[int] = []
    for k in range(ct.n):
        if k < len(ct.resolved) and ct.resolved[k] and ct.pks[k]:
            chains.append((ct.pks[k], ct.target_ids[k]))
            owners.append(k)
    if not chains:
        return set(), 0, False
    demoted_local, probes, used = _validate_chains(
        hindex, chains, min_batch=min_batch, device=store.device)
    return {owners[j] for j in demoted_local}, probes, used


def prevalidate_chains(store: MetadataStore,
                       chains: Sequence[Tuple[Sequence[Tuple[int, str]],
                                              Optional[int]]],
                       *, min_batch: Optional[int] = None
                       ) -> Optional[Tuple[List[bool], int, bool]]:
    """Namenode-side flavour of :func:`validate_window_pks` for the
    grouped read path: ``chains`` are the hint chains a read run is about
    to trust.  Returns ``(ok flags, probes, used_kernel)`` or None when
    the store is not columnar."""
    if min_batch is None:
        min_batch = PKVAL_MIN_BATCH          # runtime lookup: patchable
    try:
        t = store.table("inode")
    except Exception:
        return None
    hindex = getattr(t, "hindex", None)
    if hindex is None:
        return None
    demoted, probes, used = _validate_chains(
        hindex, chains, min_batch=min_batch, device=store.device)
    return [k not in demoted for k in range(len(chains))], probes, used


# ---------------------------------------------------------------------------
# fused subtree wave expansion (treeagg kernel launch site)
# ---------------------------------------------------------------------------


class WaveExpansion:
    """One BFS wave resolved in a single fused treeagg launch.

    ``wave`` is the sorted unique member ids the per-member arrays are
    aligned to; ``counts``/``dirs``/``sizes`` are int64 segment sums over
    each member's direct children; ``child_ids``/``child_dir_ids`` the
    children themselves (``child_dir_ids`` is the next frontier)."""

    __slots__ = ("wave", "counts", "dirs", "sizes", "child_ids",
                 "child_dir_ids")

    def __init__(self, wave, counts, dirs, sizes, child_ids, child_dir_ids):
        self.wave = wave
        self.counts = counts
        self.dirs = dirs
        self.sizes = sizes
        self.child_ids = child_ids
        self.child_dir_ids = child_dir_ids

    @property
    def n_children(self) -> int:
        return int(self.counts.sum())


def expand_wave(store: MetadataStore, wave_ids: Iterable[int], *,
                min_batch: Optional[int] = None
                ) -> Optional[WaveExpansion]:
    """Resolve one subtree BFS wave — every member's direct children plus
    the ``du``/``content_summary`` segment sums — in ONE ``treeagg``
    launch on the store's device, over the device mirror of the columnar
    inode table's hot columns.

    Returns None on the dict backend or below the slot-count gate (small
    tables then behave identically to the dict store).  Sizes are summed
    as int32 inside the launch and widened to int64 here; the modeled file
    sizes stay far below the 2^31 partial-sum bound."""
    if min_batch is None:
        min_batch = TREEAGG_MIN_BATCH        # runtime lookup: patchable
    try:
        t = store.table("inode")
    except KeyError:
        return None
    if not isinstance(t, ColumnarTable) or "size" not in t._hot:
        return None
    if t._top < max(2, min_batch):
        return None
    wave = np.unique(np.fromiter(wave_ids, dtype=np.int64))
    if wave.size == 0:
        return None
    cols = t.device_columns(store.device)
    from ..kernels.treeagg.ops import treeagg_expand
    counts, dirs, sizes, child_ids, child_dir_ids = treeagg_expand(
        wave, cols["id"], cols["parent_id"], cols["is_dir"], cols["size"])
    return WaveExpansion(wave, counts.astype(np.int64),
                         dirs.astype(np.int64), sizes.astype(np.int64),
                         child_ids, child_dir_ids)


# ---------------------------------------------------------------------------
# loading a store from plain data
# ---------------------------------------------------------------------------


def load_state(store: MetadataStore,
               tables: Mapping[str, Sequence[Sequence[Dict[str, Any]]]],
               next_inode_id: int) -> None:
    """Fill an empty store from plain Python data: for each table name,
    its partitions' rows, each partition in scan (insertion) order, and the
    position of the inode id allocator.

    Rows are put partition by partition in the order given, so every
    per-partition scan of the loaded store — and with it the columnar
    slot order that scans follow — matches the store the data came from."""
    for name, parts in tables.items():
        t = store.table(name)
        for part in parts:
            for row in part:
                t.put(dict(row))
    seq = store.table("id_seq")
    row = dict(seq.get(("inode",)) or {"seq_name": "inode"})
    row["next"] = next_inode_id
    seq.put(row)
