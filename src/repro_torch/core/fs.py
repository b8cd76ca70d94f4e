"""HopsFS inode operations (paper §5) as three-phase transactions.

Every operation follows the Figure-4 template and reproduces Table 3's
round-trip profile. Two resolution regimes exist per op:

  * **cache hit**  — the inode hint cache supplies the composite PK of every
    path component, so ancestors are validated with one *batched* PK read
    (1 round trip) at read-committed, and the target (+parent for mutating
    ops) is lock-read in one more batch. Cost is **independent of depth**.
  * **cache miss** — recursive resolution: one read-committed PK read per
    component (≈N round trips), repairing the cache along the way; mutating
    ops additionally re-validate the path under lock (≈2N total).

Round-trip accounting conventions (checked against Table 3 by
``benchmarks/bench_table3_costmodel.py``; deltas ≤1 RT are documented there):

  - one batch = one round trip irrespective of rows inside;
  - single PK reads count as PK_rc/PK_r/PK_w by lock mode;
  - commit flushes ≤8 dirty rows as per-row PK_w ops, larger sets as batches
    (Fig 4 line 8, "transfer the changes in batches");
  - file-related metadata (block/replica/URB/PRB/RUC/CR/ER/Inv) is read via
    partition-pruned index scans on the file's inode id (§4.2), 1 RT each;
    with ADP disabled (Fig 12/13 ablation) these degrade to all-shard IS.

Subtree-lock interaction (§6.3): resolution aborts with
:class:`SubtreeLockedError` when any path component carries a live subtree
lock; locks owned by dead namenodes are reclaimed in-line (§6.2).
"""
from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .hint_cache import InodeHintCache
from .store import (EXCLUSIVE, READ_COMMITTED, SHARED, MetadataStore, OpCost,
                    StoreError)
from .tables import (ROOT_ID, make_block, make_inode, make_replica,
                     split_path)
from .transactions import Transaction


class FSError(StoreError):
    pass


class FileNotFound(FSError):
    pass


class FileAlreadyExists(FSError):
    pass


class SubtreeLockedError(FSError):
    """Path crosses a subtree currently locked by another namenode (§6.3).
    Callers voluntarily abort and retry after the lock is released."""


class LeaseConflict(FSError):
    """Block write (add_block/append/complete_block) on a file under
    construction by ANOTHER client. ``append`` — which acquires the lease
    itself — may take over once the holder's lease expired; the other
    block ops must wait for the holder to finish or for the leader to
    reclaim the lease once the holder stops renewing (the client analogue
    of §6.2's dead-namenode lock reclaim)."""


@dataclass
class OpResult:
    """Return value of every FS op: payload + measured cost profile.

    ``hints`` is the response-piggybacked hint set (§5.1 applied to the
    CLIENT side of the metadata path): the ``(parent_id, name, inode_id)``
    resolutions the serving namenode's hint cache holds for the op's
    path(s) after execution. Clients absorb them into their own
    :class:`~repro_torch.core.hint_cache.InodeHintCache` so client-side planning
    warms from responses instead of reading namenode caches — see
    ``docs/HINTS.md``. Attached by the namenode RPC layer
    (:meth:`~repro_torch.core.namenode.Namenode.invoke`), charge-free (pure
    in-memory peeks, no ``OpCost`` round trips)."""
    value: Any
    cost: OpCost
    hints: Tuple[Tuple[int, str, int], ...] = ()
    #: election-clock tick at which the serving namenode finished the op
    #: (stamped by the RPC layer, ``Namenode._finish_op`` /
    #: ``_commit_group``) — the admission layer's goodput measure is
    #: ``completed_at <= WorkloadOp.deadline``. None outside a namenode.
    completed_at: Optional[int] = None


@dataclass
class ResolvedPath:
    """Outcome of the lock phase: ancestor rows, parent row, target row
    (None when the target does not exist), and whether hints hit."""
    ancestors: List[Dict[str, Any]]
    parent: Dict[str, Any]
    target: Optional[Dict[str, Any]]
    cache_hit: bool


# canonical splitter lives in tables.py (shared with hint_cache and the
# planner); re-exported here for the many `from .fs import split_path` users

def format_fs(store: MetadataStore) -> None:
    """Create the root inode and the id sequence rows."""
    store.table("inode").put(make_inode(ROOT_ID, 0, "", True))
    store.table("id_seq").put({"seq_name": "inode", "next": ROOT_ID + 1})
    store.table("id_seq").put({"seq_name": "block", "next": 1})


class IdAllocator:
    """Namenodes grab id blocks from the DB (one write per `block` ids), so
    id allocation is neither a bottleneck nor a source of txn conflicts."""

    def __init__(self, store: MetadataStore, seq: str, block: int = 1000):
        self.store, self.seq, self.block = store, seq, block
        self._next = 0
        self._limit = 0
        self._mu = threading.Lock()

    def next_id(self) -> int:
        with self._mu:
            if self._next >= self._limit:
                t = self.store.table("id_seq")
                row = dict(t.get((self.seq,)))
                self._next = row["next"]
                self._limit = row["next"] + self.block
                row["next"] = self._limit
                t.put(row)
            v = self._next
            self._next += 1
            return v


# file-related table groups per op (Table 3's ``f_s == 0 ? a : b`` PPIS sets)
_PPIS_CREATE_EMPTY = ("block", "inv")
_PPIS_CREATE_FULL = ("block", "replica", "urb", "prb", "ruc", "cr", "er", "inv")
_PPIS_READ_EMPTY = ("block",)
_PPIS_READ_FULL = ("block", "replica", "cr", "ruc", "er")
_PPIS_DEL_EMPTY = ("block", "inv")
_PPIS_DEL_FULL = ("block", "replica", "urb", "prb", "ruc", "cr", "inv")
_PPIS_ADDBLK_EMPTY = ("block", "ruc")
_PPIS_ADDBLK_FULL = ("block", "replica", "urb", "prb", "ruc", "inv")
_PPIS_TRUNC = ("block", "replica", "ruc", "inv")


class HopsFSOps:
    """Inode (single-file/dir) operations for one namenode.

    ``use_cache`` / ``distribution_aware`` / ``adp`` toggles reproduce the
    Fig 12/13 ablations (ADP off => file-related scans cannot be pruned and
    degrade to all-shard index scans).
    """

    def __init__(self, store: MetadataStore, namenode_id: int = 0, *,
                 use_cache: bool = True, distribution_aware: bool = True,
                 adp: bool = True,
                 is_nn_alive: Optional[Callable[[int], bool]] = None,
                 lease_now: Optional[Callable[[], int]] = None,
                 lease_limit: int = 3,
                 lease_soft_limit: Optional[int] = None):
        self.store = store
        self.nn_id = namenode_id
        self.cache: Optional[InodeHintCache] = (
            InodeHintCache() if use_cache else None)
        self.dat = distribution_aware
        self.adp = adp
        self.inode_ids = IdAllocator(store, "inode")
        self.block_ids = IdAllocator(store, "block")
        self.clock = itertools.count(1)
        # liveness oracle for subtree-lock reclaim (§6.2); defaults to
        # "only me is alive" for single-NN tests
        self._is_nn_alive = is_nn_alive or (lambda nn: nn == self.nn_id)
        # lease clock: client liveness is measured against the SAME logical
        # clock the leader election uses (a Namenode wires this to
        # election.now); a lease not renewed for > lease_limit ticks is
        # expired and reclaimable by the leader. The standalone default
        # (constant 0) never expires leases, keeping single-NN tests inert.
        self._lease_now = lease_now or (lambda: 0)
        self.lease_limit = lease_limit
        # HDFS recoverLease semantics: past the SOFT limit a NEW writer
        # may force takeover (append / recover_lease); only past the HARD
        # limit (lease_limit) does the leader's sweep reclaim. Defaults to
        # the hard limit, i.e. no takeover window, the pre-soft behaviour.
        self.lease_soft_limit = (lease_limit if lease_soft_limit is None
                                 else min(lease_soft_limit, lease_limit))
        # treeagg kernel telemetry: fused du aggregation launches on the
        # columnar backend (dict stores never launch)
        self.treeagg_launches = 0

    # ------------------------------------------------------------------
    # transaction / lock-phase helpers
    # ------------------------------------------------------------------
    def _begin(self, pkey: Any) -> Transaction:
        return Transaction(self.store, partition_hint=("inode", pkey),
                           distribution_aware=self.dat)

    def _hint_for(self, comps: Sequence[str], *, parent: bool) -> Any:
        """Partition-key hint for the transaction (Fig 4 line 2): the
        file's inode id for file ops (file-related rows live there), the
        parent's id for namespace-mutating ops."""
        if self.cache is None:
            return ROOT_ID
        v = self.cache.last_resolved_id(comps[:-1] if parent else comps)
        return v if v is not None else ROOT_ID

    def _file_scan(self, txn: Transaction, tables: Sequence[str],
                   inode_id: int, lock: str = READ_COMMITTED
                   ) -> Dict[str, List[Dict[str, Any]]]:
        out = {}
        for tname in tables:
            if self.adp:
                out[tname] = txn.ppis(tname, "inode_id", inode_id, lock)
            else:
                out[tname] = txn.index_scan(tname, "inode_id", inode_id, lock)
        return out

    def _children(self, txn: Transaction, dir_id: int,
                  lock: str = READ_COMMITTED) -> List[Dict[str, Any]]:
        """Directory listing scan: partition-pruned because inodes are
        partitioned by parent_id (the paper's headline ADP win, §4.2)."""
        if self.adp:
            return txn.ppis("inode", "parent_id", dir_id, lock)
        return txn.index_scan("inode", "parent_id", dir_id, lock)

    def _check_subtree_lock(self, row: Dict[str, Any],
                            txn: Transaction) -> None:
        owner = row.get("subtree_lock")
        if owner is None:
            return
        if self._is_nn_alive(owner) and owner != self.nn_id:
            raise SubtreeLockedError(
                f"inode {row['id']} subtree-locked by NN {owner}")
        if owner != self.nn_id:
            fixed = dict(row)
            fixed["subtree_lock"] = None          # reclaim from dead NN §6.2
            txn.write("inode", fixed)
            row["subtree_lock"] = None

    # ------------------------------------------------------------------
    # lease table helpers (§4.1 lease/lease_path; HDFS single-writer rule)
    # ------------------------------------------------------------------
    def lease_write(self, txn: Transaction, client: str,
                    inode_id: int) -> None:
        """Acquire/renew ``client``'s lease on a file inside the current
        transaction: one lease row per holder (renewal timestamp against
        the shared liveness clock) plus one lease_path row per file under
        construction. Shared by the sequential handlers AND the grouped
        write path (create/append), so the two cannot diverge."""
        txn.write("lease", {"holder": client,
                            "last_renewed": self._lease_now()})
        txn.write("lease_path", {"inode_id": inode_id, "holder": client})

    def _lease_live(self, row: Optional[Dict[str, Any]]) -> bool:
        """A lease is live iff it exists and was renewed within
        ``lease_limit`` liveness ticks — the client analogue of the
        namenode heartbeat rule (leader.py)."""
        return (row is not None
                and self._lease_now() - row.get("last_renewed", 0)
                <= self.lease_limit)

    def _lease_live_soft(self, row: Optional[Dict[str, Any]]) -> bool:
        """Soft-limit liveness: within ``lease_soft_limit`` ticks the
        holder is protected even from takeover ops; between the soft and
        hard limits a NEW writer may force recovery (append's takeover,
        :meth:`recover_lease`) while the leader's sweep still waits for
        the hard limit — HDFS's soft/hard lease split."""
        return (row is not None
                and self._lease_now() - row.get("last_renewed", 0)
                <= self.lease_soft_limit)

    def _check_lease(self, txn: Transaction, target: Dict[str, Any],
                     client: str, path: str, *,
                     takeover: bool = False) -> None:
        """Block-write admission: a file under construction by ANOTHER
        client conflicts. Only a ``takeover`` op (append, which acquires
        the lease itself via :meth:`lease_write`) may proceed once the
        holder's lease expired; non-takeover block ops (add_block/
        complete_block) never write under another client's inode — they
        wait for the leader's recovery sweep to clear the holder, so an
        expired lease can't silently admit two concurrent writers. Reads
        go through the transaction cache (charge-free peek), so grouped
        and sequential execution observe identical lease state."""
        holder = target.get("client")
        if not target.get("under_construction") or holder in (None, client):
            return
        if not takeover \
                or self._lease_live_soft(txn.peek("lease", (holder,))):
            raise LeaseConflict(f"{path}: lease held by {holder!r}")

    def renew_lease(self, *, client: str = "client") -> OpResult:
        """Client heartbeat: one bounded-time lease-row write, exactly the
        namenode liveness pattern of leader.py applied to writers."""
        with Transaction(self.store, partition_hint=("lease", client),
                         distribution_aware=self.dat) as txn:
            txn.read("lease", (client,), EXCLUSIVE)
            txn.write("lease", {"holder": client,
                                "last_renewed": self._lease_now()})
            cost = txn.commit()
        return OpResult(None, cost)

    def touch_lease(self, client: str) -> bool:
        """Piggybacked lease renewal (the HDFS lease-manager semantics,
        ROADMAP PR-4 follow-up): ANY registered op executed by a live
        lease holder refreshes its stamp, so a steadily-writing client
        never needs a bare ``renew_lease`` heartbeat to survive the
        leader's recovery sweep. Renewal rides the RPC, not the op's
        transaction — a charge-free row touch (Table-3 round-trip
        profiles unchanged) — but it DOES take the lease row's exclusive
        lock, so it serializes against :meth:`lease_recover`'s
        under-lock liveness re-check: a touch either lands before the
        reclaim (recovery then sees a live stamp and skips) or waits
        until the reclaim committed (the row is gone and the touch is a
        no-op — the holder's next create/append re-leases). Returns
        False when ``client`` holds no lease."""
        t = self.store.table("lease")
        if t.get((client,)) is None:
            return False
        txn_id = self.store.next_txn_id()
        try:
            try:
                self.store.locks.acquire(txn_id, "lease", (client,),
                                         EXCLUSIVE)
            except StoreError:
                # renewal is best-effort: the op itself already succeeded,
                # so a lock-wait timeout must not convert it into an error
                # — the holder's next op (or bare renew_lease) renews
                return False
            row = t.get((client,))       # re-read under the lock
            if row is None:
                return False             # reclaimed while we waited
            row = dict(row)
            row["last_renewed"] = self._lease_now()
            t.put(row)
            return True
        finally:
            self.store.locks.release_all(txn_id)

    def expired_lease_holders(self) -> List[str]:
        """Holders whose lease outlived ``lease_limit`` liveness ticks —
        the leader's lease-recovery work list."""
        rows = self.store.table("lease").scan_all(
            lambda r: not self._lease_live(r))
        return sorted(r["holder"] for r in rows)

    def lease_recover(self, holder: str) -> OpResult:
        """Reclaim one dead client's lease (leader housekeeping; the lease
        analogue of §6.2's subtree-lock reclaim): clear under-construction
        state on every file the holder leased, drop its lease_path rows
        (partition-pruned — lease_path is partitioned by holder), then
        drop the lease row itself. Liveness is RE-CHECKED under the lease
        row's exclusive lock immediately before the reclaim commits: a
        holder that renewed between the leader's ``expired_lease_holders``
        scan and this transaction (e.g. a piggybacked ``touch_lease`` from
        an in-flight op) keeps its lease — the transaction ABORTS,
        discarding every cached write. The lease lock is taken LAST, after
        the inode rows, preserving the FS layer's inode-before-lease
        acquisition order (``lease_write`` in every writer's txn), so the
        re-check cannot deadlock against an in-flight create/append."""
        with Transaction(self.store, partition_hint=("lease_path", holder),
                         distribution_aware=self.dat) as txn:
            lps = txn.ppis("lease_path", "holder", holder, EXCLUSIVE)
            for lp in lps:
                for row in txn.index_scan("inode", "id", lp["inode_id"],
                                          EXCLUSIVE):
                    if row.get("client") == holder:
                        fixed = dict(row)
                        fixed["under_construction"] = False
                        fixed["client"] = None
                        txn.write("inode", fixed)
                txn.delete("lease_path", (lp["inode_id"],))
            row = txn.read("lease", (holder,), EXCLUSIVE)
            if self._lease_live(row):
                # renewed since the scan: abort (writes above were only
                # cached, nothing flushed) — not reclaimed (value None)
                cost = txn.cost.copy()
                txn.abort()
                return OpResult(None, cost)
            txn.delete("lease", (holder,))
            cost = txn.commit()
        return OpResult(len(lps), cost)

    def scrub_leases(self) -> OpResult:
        """Leader housekeeping: drop lease_path rows whose file is gone.
        The HDFS LeaseManager removes a path entry the moment its file is
        deleted; this model defers the removal to a housekeeping sweep so
        the delete transaction keeps its Table-3 round-trip profile.
        Returns the number of rows scrubbed."""
        with Transaction(self.store, partition_hint=("lease_path", "client"),
                         distribution_aware=self.dat) as txn:
            scrubbed = 0
            for lp in txn.full_scan("lease_path", lambda r: True):
                if txn.index_scan("inode", "id", lp["inode_id"]):
                    continue                      # file still exists
                txn.read("lease_path", (lp["inode_id"],), EXCLUSIVE)
                txn.delete("lease_path", (lp["inode_id"],))
                scrubbed += 1
            cost = txn.commit()
        return OpResult(scrubbed, cost)

    def recover_lease(self, path: str, *, client: str = "client"
                      ) -> OpResult:
        """Client-initiated lease recovery (the HDFS ``recoverLease`` RPC):
        a NEW writer forces recovery of ``path``'s expired lease instead
        of waiting for the leader's sweep.  Admission mirrors ``append``'s
        takeover rule — the holder's lease must have outlived the SOFT
        limit (``lease_soft_limit`` liveness ticks without renewal, which
        may be shorter than the hard ``lease_limit`` the leader's sweep
        honours); a holder inside the soft limit raises
        :class:`LeaseConflict`.  Lock order matches every
        other writer (inode first, the holder's lease row LAST), so the
        under-lock liveness re-check serializes against the holder's own
        piggybacked renewals exactly like ``lease_recover``.  Returns True
        when the lease was recovered, False when there was nothing to
        recover (not under construction, or already ours)."""
        comps = split_path(path)
        with self._begin(self._hint_for(comps, parent=False)) as txn:
            rp = self._resolve(
                txn, comps, last_lock=EXCLUSIVE, path=path,
                aux=(("lease", lambda p, t:
                      ((t.get("client") or client,) if t else None),
                      READ_COMMITTED),))
            target = rp.target
            if target is None or target["is_dir"]:
                raise FileNotFound(path)
            holder = target.get("client")
            if not target.get("under_construction") \
                    or holder in (None, client):
                cost = txn.commit()
                return OpResult(False, cost)
            # clear the file's writer state (cached until commit)
            fixed = dict(target)
            fixed["under_construction"] = False
            fixed["client"] = None
            txn.write("inode", fixed)
            txn.delete("lease_path", (target["id"],))
            # holder's lease row X-locked LAST: the soft-limit check runs
            # under the lock, so a concurrent renewal wins cleanly
            row = txn.read("lease", (holder,), EXCLUSIVE)
            if self._lease_live_soft(row):
                cost = txn.cost.copy()
                txn.abort()
                raise LeaseConflict(
                    f"{path}: lease held by {holder!r} is still live")
            others = [lp for lp in txn.ppis("lease_path", "holder", holder,
                                            READ_COMMITTED)
                      if lp["inode_id"] != target["id"]]
            if row is not None and not others:
                txn.delete("lease", (holder,))    # last path: drop holder
            cost = txn.commit()
        return OpResult(True, cost)

    def _resolve(self, txn: Transaction, comps: Sequence[str], *,
                 last_lock: str, lock_parent: bool = False,
                 revalidate: bool = False, lock_last_in_batch: bool = False,
                 aux: Sequence[Tuple[str, Callable[[int, Optional[Dict]],
                                                   Optional[Tuple]], str]] = (),
                 path: str = "") -> ResolvedPath:
        """Lock phase (Fig 4 lines 1-5) with Table-3 batching conventions.

        cache hit : one batch validates the ancestors at read-committed
                    (optionally locking the target in the same batch for
                    ``lock_last_in_batch`` ops like addBlock); mutating ops
                    lock (parent, target) in a second batch; every ``aux``
                    read (lease/quota checks) is its own batch.
        cache miss: recursive single reads over the path (+ an under-lock
                    revalidation pass for mutating ops); all ``aux`` reads
                    fold into ONE batch (together with the target lock for
                    ``lock_last_in_batch``); the (parent, target) lock batch
                    stays separate.

        ``aux`` entries are (table, pk_fn(parent_id, target_row) -> pk|None,
        lock); a None pk skips the read.
        """
        path = path or "/" + "/".join(comps)
        if not comps:
            row = txn.read("inode", (0, ""), last_lock or SHARED)
            if row is None:
                raise FileNotFound("/")
            for tname, pk_fn, lk in aux:
                pk = pk_fn(ROOT_ID, row)
                if pk is not None:
                    with txn.batch() as b:
                        b.read(tname, pk, lk)
            return ResolvedPath([], row, row, True)

        pks = self.cache.resolve_pks(comps) if self.cache else None
        ancestors: List[Dict[str, Any]] = []
        hit = False
        parent_pk: Tuple[int, str] = (0, "")     # PK of the parent inode
        parent_id = ROOT_ID
        target: Optional[Dict[str, Any]] = None
        target_read = False
        if pks is not None:
            anc_pks = pks[:-1]
            with txn.batch() as b:
                got = [b.read("inode", pk, READ_COMMITTED)
                       for pk in anc_pks]
                ok = all(g is not None for g in got)
                if ok:
                    parent = ROOT_ID
                    for pk, g in zip(anc_pks, got):
                        if pk[0] != parent:
                            ok = False
                            break
                        parent = g["id"]
                if ok and lock_last_in_batch:
                    pid = got[-1]["id"] if got else ROOT_ID
                    target = b.read("inode", (pid, comps[-1]), last_lock)
                    target_read = True
            if ok:
                ancestors = list(got)
                hit = True
                for row in ancestors:
                    self._check_subtree_lock(row, txn)
                if ancestors:
                    parent_pk = anc_pks[-1]
                    parent_id = ancestors[-1]["id"]
            else:
                for pk in anc_pks:
                    self.cache.invalidate(*pk)
                pks = None
                target, target_read = None, False
        if pks is None:
            # Recursive resolution, repairing the cache. Mutating ops
            # (revalidate=True) re-read the chain once more under the
            # protection of the locks they are about to take; when the lock
            # batch itself re-reads the parent (lock_parent), the final pass
            # stops one component earlier.
            chain1 = comps[:-2] if (lock_parent and not revalidate) \
                else comps[:-1]
            parent = ROOT_ID
            for name in chain1:
                row = txn.read("inode", (parent, name), READ_COMMITTED)
                if row is None:
                    raise FileNotFound(path)
                self._check_subtree_lock(row, txn)
                if self.cache:
                    self.cache.put(parent, name, row["id"])
                ancestors.append(row)
                parent = row["id"]
            if revalidate:
                chain2 = comps[:-2] if lock_parent else comps[:-1]
                p2 = ROOT_ID
                for name in chain2:
                    row = txn.read("inode", (p2, name), READ_COMMITTED)
                    if row is None:
                        raise FileNotFound(path)
                    p2 = row["id"]
            # derive the parent PK from what was resolved
            if len(comps) == 1:
                parent_pk, parent_id = (0, ""), ROOT_ID
            elif lock_parent:
                gp = ancestors[len(comps) - 3]["id"] if len(comps) >= 3 \
                    else ROOT_ID
                parent_pk = (gp, comps[-2])
                existing = self.store.table("inode").get(parent_pk)
                if existing is None:
                    raise FileNotFound(path)
                parent_id = existing["id"]
            else:
                parent_pk = (ancestors[-1]["parent_id"],
                             ancestors[-1]["name"])
                parent_id = ancestors[-1]["id"]

        # ---- lock batch(es) + aux reads ---------------------------------
        parent_row: Optional[Dict[str, Any]] = None
        if lock_parent:
            got2 = txn.read_batch([("inode", parent_pk, EXCLUSIVE),
                                   ("inode", (parent_id, comps[-1]),
                                    last_lock)])
            parent_row, target = got2[0], got2[1]
            target_read = True
            if parent_row is None:
                raise FileNotFound(path)
        elif not target_read:
            if hit:
                target = txn.read("inode", (parent_id, comps[-1]), last_lock)
                target_read = True
            # miss + lock_last_in_batch: target joins the folded aux batch
        if parent_row is None:
            parent_row = (ancestors[-1] if len(comps) >= 2
                          else self.store.table("inode").get((0, "")))

        if hit:
            if aux:
                for tname, pk_fn, lk in aux:
                    pk = pk_fn(parent_id, target)
                    if pk is not None:
                        with txn.batch() as b:
                            b.read(tname, pk, lk)
        else:
            fold_target = lock_last_in_batch and not target_read
            if not fold_target and not target_read:
                target = txn.read("inode", (parent_id, comps[-1]), last_lock)
                target_read = True
            if aux or fold_target:
                with txn.batch() as b:
                    if fold_target:
                        target = b.read("inode", (parent_id, comps[-1]),
                                        last_lock)
                        target_read = True
                    for tname, pk_fn, lk in aux:
                        pk = pk_fn(parent_id, target)
                        if pk is not None:
                            b.read(tname, pk, lk)
        if not target_read:
            target = txn.read("inode", (parent_id, comps[-1]), last_lock)

        self._check_subtree_lock(parent_row, txn)
        if target is not None:
            self._check_subtree_lock(target, txn)
            if self.cache:
                self.cache.put(parent_id, comps[-1], target["id"])
        return ResolvedPath(ancestors, parent_row, target, hit)

    # ==================================================================
    # operations
    # ==================================================================
    # -- execute-phase apply helpers, shared with the grouped WRITE path
    # -- (namenode._write_group_txn) so batched and sequential mutations
    # -- cannot diverge: every check precedes the first txn.write, and all
    # -- shared-row reads (quota) go through the cache-aware txn.peek
    def mkdir_apply(self, txn: Transaction, parent: Dict[str, Any],
                    target: Optional[Dict[str, Any]], name: str,
                    path: str, *, perm: int = 0o755) -> int:
        if target is not None:
            raise FileAlreadyExists(path)
        if not parent["is_dir"]:
            raise FSError(f"not a directory: parent of {path}")
        new_id = self.inode_ids.next_id()
        txn.write("inode", make_inode(new_id, parent["id"], name, True,
                                      perm=perm, mtime=next(self.clock)))
        parent = dict(parent)
        parent["mtime"] = next(self.clock)
        txn.write("inode", parent)
        if self.cache:
            self.cache.put(parent["id"], name, new_id)
        return new_id

    def mkdir(self, path: str, *, perm: int = 0o755) -> OpResult:
        comps = split_path(path)
        if not comps:
            raise FileAlreadyExists("/")
        with self._begin(self._hint_for(comps, parent=True)) as txn:
            rp = self._resolve(txn, comps, last_lock=EXCLUSIVE,
                               lock_parent=True, path=path)
            new_id = self.mkdir_apply(txn, rp.parent, rp.target, comps[-1],
                                      path, perm=perm)
            cost = txn.commit()
        return OpResult(new_id, cost)

    def mkdirs(self, path: str, **kw) -> OpResult:
        """mkdir -p; cost = sum of constituent mkdirs."""
        comps = split_path(path)
        agg = OpCost()
        last = None
        for i in range(1, len(comps) + 1):
            sub = "/" + "/".join(comps[:i])
            try:
                r = self.mkdir(sub, **kw)
                agg.merge(r.cost)
                last = r.value
            except FileAlreadyExists:
                continue
        return OpResult(last, agg)

    def create_apply(self, txn: Transaction, parent: Dict[str, Any],
                     target: Optional[Dict[str, Any]], name: str,
                     path: str, *, repl: int = 3, client: str = "client",
                     overwrite: bool = False) -> int:
        if target is not None and not overwrite:
            raise FileAlreadyExists(path)
        if not parent["is_dir"]:
            raise FSError(f"not a directory: parent of {path}")
        fid = (target["id"] if target is not None
               else self.inode_ids.next_id())
        tables = (_PPIS_CREATE_FULL
                  if target is not None and target["size"] > 0
                  else _PPIS_CREATE_EMPTY)
        related = self._file_scan(txn, tables, fid, EXCLUSIVE)
        if target is not None:  # overwrite: clear old file metadata
            for tname, rws in related.items():
                schema = self.store.table(tname).schema
                for r in rws:
                    txn.delete(tname, tuple(r[c] for c in schema.pk))
        txn.write("inode", make_inode(fid, parent["id"], name,
                                      False, repl=repl,
                                      mtime=next(self.clock),
                                      client=client))
        parent2 = dict(parent)
        parent2["mtime"] = next(self.clock)
        txn.write("inode", parent2)
        self.lease_write(txn, client, fid)
        q = txn.peek("quota", (parent["id"],))
        qrow = dict(q) if q else {"inode_id": parent["id"],
                                  "ns_quota": -1, "ns_used": 0,
                                  "ss_quota": -1, "ss_used": 0}
        qrow["ns_used"] = qrow.get("ns_used", 0) + 1
        txn.write("quota", qrow)
        if self.cache:
            self.cache.put(parent["id"], name, fid)
        return fid

    def create(self, path: str, *, repl: int = 3, client: str = "client",
               overwrite: bool = False) -> OpResult:
        comps = split_path(path)
        with self._begin(self._hint_for(comps, parent=True)) as txn:
            rp = self._resolve(
                txn, comps, last_lock=EXCLUSIVE, lock_parent=True,
                revalidate=True, path=path,
                aux=(("lease", lambda p, t: (client,), READ_COMMITTED),
                     ("quota", lambda p, t: (p,), READ_COMMITTED)))
            fid = self.create_apply(txn, rp.parent, rp.target, comps[-1],
                                    path, repl=repl, client=client,
                                    overwrite=overwrite)
            cost = txn.commit()
        return OpResult(fid, cost)

    # -- block-write apply helpers, shared with the grouped WRITE path
    # -- (the lease-ordered block path): every admission check (existence,
    # -- lease conflict) precedes the first txn.write, and lease state is
    # -- read through the charge-free txn.peek so grouped and sequential
    # -- execution observe identical state
    def add_block_apply(self, txn: Transaction,
                        target: Optional[Dict[str, Any]], path: str, *,
                        client: str = "client") -> int:
        if target is None or target["is_dir"]:
            raise FileNotFound(path)
        self._check_lease(txn, target, client, path)
        tables = (_PPIS_ADDBLK_EMPTY if target["size"] == 0
                  else _PPIS_ADDBLK_FULL)
        related = self._file_scan(txn, tables, target["id"], EXCLUSIVE)
        blocks = related.get("block", [])
        # finalize/inspect the penultimate block: 1 PK_r
        prev_pk = (max(blocks, key=lambda b: b["index"])["block_id"],) \
            if blocks else (-1,)
        txn.read("block", prev_pk, SHARED)
        bid = self.block_ids.next_id()
        # only the block row is written here; the replica-under-
        # construction rows appear when the datanode write pipeline
        # starts (complete_block), matching Table 3's single PK_w
        txn.write("block", make_block(bid, target["id"], len(blocks)))
        return bid

    def add_block(self, path: str, *,
                  client: str = "client") -> OpResult:
        comps = split_path(path)
        with self._begin(self._hint_for(comps, parent=False)) as txn:
            rp = self._resolve(
                txn, comps, last_lock=EXCLUSIVE, lock_last_in_batch=True,
                path=path,
                aux=(("lease", lambda p, t:
                      ((t.get("client") or "client",) if t else None),
                      READ_COMMITTED),))
            bid = self.add_block_apply(txn, rp.target, path, client=client)
            cost = txn.commit()
        return OpResult(bid, cost)

    def complete_block_apply(self, txn: Transaction,
                             target: Optional[Dict[str, Any]], path: str, *,
                             block_id: int = -1, size: int,
                             datanodes: Sequence[int] = (0, 1, 2),
                             client: str = "client") -> None:
        if target is None or target["is_dir"]:
            raise FileNotFound(path)
        self._check_lease(txn, target, client, path)
        if block_id is None or block_id < 0:
            # "the last allocated block" — lets trace records complete
            # blocks whose ids were allocated at replay time
            blocks = self._file_scan(txn, ("block",), target["id"],
                                     EXCLUSIVE).get("block", [])
            if not blocks:
                raise FileNotFound(f"no block to complete in {path}")
            block_id = max(blocks, key=lambda b: b["index"])["block_id"]
        blk = txn.read("block", (block_id,), EXCLUSIVE)
        if blk is None:
            raise FileNotFound(f"block {block_id}")
        blk = dict(blk)
        blk["size"], blk["state"] = size, "COMPLETE"
        txn.write("block", blk)
        rucs = self._file_scan(txn, ("ruc",), target["id"],
                               EXCLUSIVE)["ruc"]
        for r in rucs:
            if r["block_id"] == block_id:
                txn.delete("ruc", (r["block_id"], r["datanode_id"]))
        for dn in datanodes[:target["repl"]]:
            txn.write("replica", make_replica(block_id, target["id"], dn))
        f = dict(target)
        f["size"] += size
        txn.write("inode", f)
        return None

    def complete_block(self, path: str, block_id: int = -1, *, size: int,
                       datanodes: Sequence[int] = (0, 1, 2),
                       client: str = "client") -> OpResult:
        comps = split_path(path)
        with self._begin(self._hint_for(comps, parent=False)) as txn:
            rp = self._resolve(txn, comps, last_lock=EXCLUSIVE, path=path)
            self.complete_block_apply(txn, rp.target, path,
                                      block_id=block_id, size=size,
                                      datanodes=datanodes, client=client)
            cost = txn.commit()
        return OpResult(None, cost)

    # -- read-op payload phases, shared with the batched pipeline so the
    # -- two execution paths cannot diverge (namenode._complete_read_op)
    def read_payload(self, txn: Transaction,
                     target: Dict[str, Any]) -> List[Dict[str, Any]]:
        tables = (_PPIS_READ_EMPTY if target["size"] == 0
                  else _PPIS_READ_FULL)
        related = self._file_scan(txn, tables, target["id"], READ_COMMITTED)
        blocks = sorted(related.get("block", []), key=lambda b: b["index"])
        reps = related.get("replica", [])
        return [{"block": b["block_id"], "size": b["size"],
                 "locations": [r["datanode_id"] for r in reps
                               if r["block_id"] == b["block_id"]]}
                for b in blocks]

    @staticmethod
    def stat_payload(target: Dict[str, Any]) -> Dict[str, Any]:
        return {k: target[k] for k in ("id", "is_dir", "perm", "owner",
                                       "group", "size", "repl", "mtime")}

    def listing_payload(self, txn: Transaction,
                        target: Dict[str, Any]) -> List[str]:
        if not target["is_dir"]:
            return []
        return sorted(c["name"]
                      for c in self._children(txn, target["id"], SHARED))

    def get_block_locations(self, path: str) -> OpResult:
        """The `read` op of Table 1/3 (68.7% of the Spotify workload)."""
        comps = split_path(path)
        with self._begin(self._hint_for(comps, parent=False)) as txn:
            rp = self._resolve(
                txn, comps, last_lock=SHARED, path=path,
                aux=(("lease", lambda p, t:
                      ((t.get("client") or "client",) if t else None),
                      READ_COMMITTED),))
            f = rp.target
            if f is None:
                raise FileNotFound(path)
            locs = self.read_payload(txn, f)
            cost = txn.commit()
        return OpResult(locs, cost)

    read = get_block_locations

    def listing(self, path: str) -> OpResult:
        comps = split_path(path)
        with self._begin(self._hint_for(comps, parent=False)) as txn:
            rp = self._resolve(txn, comps, last_lock=SHARED, path=path)
            node = rp.target
            if node is None:
                raise FileNotFound(path)
            names = self.listing_payload(txn, node)
            cost = txn.commit()
        return OpResult(names, cost)

    def stat(self, path: str) -> OpResult:
        comps = split_path(path)
        with self._begin(self._hint_for(comps, parent=False)) as txn:
            rp = self._resolve(
                txn, comps, last_lock=SHARED, path=path,
                aux=(("lease", lambda p, t:
                      ((t.get("client") or "client",) if t else None),
                      READ_COMMITTED),))
            node = rp.target
            if node is None:
                raise FileNotFound(path)
            info = self.stat_payload(node)
            cost = txn.commit()
        return OpResult(info, cost)

    info = stat

    def setattr_apply(self, txn: Transaction,
                      node: Optional[Dict[str, Any]], path: str,
                      mutate: Callable[[Dict[str, Any]], None]) -> None:
        if node is None:
            raise FileNotFound(path)
        if node["is_dir"]:
            # no active subtree op may exist below: all-shard IS on the
            # subtree-ops table (Table 3: "i is a dir ? IS : PPIS")
            txn.index_scan("ongoing_subtree_ops", "namenode_id",
                           self.nn_id)
        else:
            self._file_scan(txn, ("block",), node["id"], READ_COMMITTED)
        node = dict(node)
        mutate(node)
        node["mtime"] = next(self.clock)
        txn.write("inode", node)
        q = txn.peek("quota", (node["parent_id"],))
        txn.write("quota", dict(q) if q else
                  {"inode_id": node["parent_id"], "ns_quota": -1,
                   "ns_used": 0, "ss_quota": -1, "ss_used": 0})
        return None

    def _simple_update(self, path: str,
                       mutate: Callable[[Dict[str, Any]], None]) -> OpResult:
        """chmod/chown/setrepl on FILES (and the phase-3 root-only update for
        directory subtree ops — see subtree.py)."""
        comps = split_path(path)
        with self._begin(self._hint_for(comps, parent=False)) as txn:
            rp = self._resolve(
                txn, comps, last_lock=EXCLUSIVE, revalidate=True, path=path,
                aux=(("lease", lambda p, t:
                      ((t.get("client") or "client",) if t else None),
                      READ_COMMITTED),
                     ("quota", lambda p, t: (p,), READ_COMMITTED)))
            self.setattr_apply(txn, rp.target, path, mutate)
            cost = txn.commit()
        return OpResult(None, cost)

    def chmod_file(self, path: str, perm: int) -> OpResult:
        return self._simple_update(path, lambda n: n.update(perm=perm))

    def chown_file(self, path: str, owner: str) -> OpResult:
        return self._simple_update(path, lambda n: n.update(owner=owner))

    def set_replication(self, path: str, repl: int) -> OpResult:
        return self._simple_update(path, lambda n: n.update(repl=repl))

    def delete_file(self, path: str) -> OpResult:
        comps = split_path(path)
        with self._begin(self._hint_for(comps, parent=True)) as txn:
            rp = self._resolve(
                txn, comps, last_lock=EXCLUSIVE, lock_parent=True,
                revalidate=True, path=path,
                aux=(("lease", lambda p, t:
                      ((t.get("client") or "client",) if t else None),
                      READ_COMMITTED),
                     ("quota", lambda p, t: (p,), READ_COMMITTED)))
            node = rp.target
            if node is None:
                raise FileNotFound(path)
            if node["is_dir"]:
                raise FSError("use subtree delete for directories")
            tables = _PPIS_DEL_EMPTY if node["size"] == 0 else _PPIS_DEL_FULL
            related = self._file_scan(txn, tables, node["id"], EXCLUSIVE)
            for tname, rws in related.items():
                schema = self.store.table(tname).schema
                for r in rws:
                    txn.delete(tname, tuple(r[c] for c in schema.pk))
            txn.delete("inode", (node["parent_id"], node["name"]))
            parent = dict(rp.parent)
            parent["mtime"] = next(self.clock)
            txn.write("inode", parent)
            if self.cache:
                self.cache.invalidate(node["parent_id"], node["name"])
            cost = txn.commit()
        return OpResult(None, cost)

    def content_summary(self, path: str) -> OpResult:
        comps = split_path(path)
        with self._begin(self._hint_for(comps, parent=False)) as txn:
            rp = self._resolve(
                txn, comps, last_lock=SHARED, path=path,
                aux=(("quota", lambda p, t:
                      ((t["id"],) if t else None), READ_COMMITTED),))
            node = rp.target
            if node is None:
                raise FileNotFound(path)
            n_children = 0
            if node["is_dir"]:
                n_children = len(self._children(txn, node["id"]))
            cost = txn.commit()
        return OpResult({"children": n_children, "size": node["size"]}, cost)

    def _expand_wave_fused(self, wave: Sequence[int]) -> Optional[Any]:
        """Columnar-only fused wave expansion for deep aggregation: one
        ``treeagg`` launch resolves a whole BFS wave's children and
        segment sums.  None on the dict backend / below the gate."""
        from .columnar import expand_wave
        exp = expand_wave(self.store, wave)
        if exp is not None:
            self.treeagg_launches += 1
        return exp

    def du(self, path: str) -> OpResult:
        """Deep content summary (HDFS ``du -s``): inode/file/dir counts
        and total size over the WHOLE subtree, not just the immediate
        children :meth:`content_summary` reports.

        The walk is wave-by-wave BFS.  On the dict backend each wave is a
        transaction of READ_COMMITTED partition-pruned child scans (one
        PPIS per directory, §4.2).  On the columnar backend each wave is
        instead ONE fused treeagg launch over the inode hot columns on the
        store's device — still charged as the wave's PPIS fan-out plus a
        single batched exchange, with the touched rows mirrored into the
        store's row-op ledger, so cost conservation holds without per-row
        transactions.  Results are identical across backends; costs
        intentionally differ (that asymmetry IS the kernel's win)."""
        comps = split_path(path)
        with self._begin(self._hint_for(comps, parent=False)) as txn:
            rp = self._resolve(
                txn, comps, last_lock=SHARED, path=path,
                aux=(("quota", lambda p, t:
                      ((t["id"],) if t else None), READ_COMMITTED),))
            node = rp.target
            if node is None:
                raise FileNotFound(path)
            cost = txn.commit()
        if not node["is_dir"]:
            return OpResult({"inodes": 1, "files": 1, "dirs": 0,
                             "size": node["size"]}, cost)
        inodes, files, dirs, size = 1, 0, 1, 0
        wave: List[int] = [node["id"]]
        while wave:
            exp = self._expand_wave_fused(wave)
            if exp is not None:
                n_children = exp.n_children
                nd = int(exp.dirs.sum())
                inodes += n_children
                dirs += nd
                files += n_children - nd
                size += int(exp.sizes.sum())
                cost.ppis += len(wave)
                cost.batches += 1
                cost.batch_rows += n_children
                cost.remote_rt += 1
                cost.rows_touched += n_children
                self.store.total_row_ops += n_children
                wave = [int(i) for i in exp.child_dir_ids]
            else:
                nxt: List[int] = []
                with Transaction(self.store,
                                 partition_hint=("inode", wave[0]),
                                 distribution_aware=self.dat) as txn:
                    for did in wave:
                        for k in self._children(txn, did):
                            inodes += 1
                            if k["is_dir"]:
                                dirs += 1
                                nxt.append(k["id"])
                            else:
                                files += 1
                                size += k["size"]
                    cost.merge(txn.commit())
                wave = nxt
        return OpResult({"inodes": inodes, "files": files, "dirs": dirs,
                         "size": size}, cost)

    def set_quota(self, path: str, *, ns_quota: int = -1,
                  ss_quota: int = -1) -> OpResult:
        comps = split_path(path)
        with self._begin(self._hint_for(comps, parent=False)) as txn:
            rp = self._resolve(txn, comps, last_lock=EXCLUSIVE,
                               revalidate=True, path=path)
            node = rp.target
            if node is None:
                raise FileNotFound(path)
            q = self.store.table("quota").get((node["id"],))
            qrow = dict(q) if q else {"inode_id": node["id"], "ns_used": 0,
                                      "ss_used": 0}
            qrow["ns_quota"], qrow["ss_quota"] = ns_quota, ss_quota
            txn.write("quota", qrow)
            cost = txn.commit()
        return OpResult(None, cost)

    def append_apply(self, txn: Transaction,
                     target: Optional[Dict[str, Any]], path: str, *,
                     client: str = "client") -> int:
        if target is None or target["is_dir"]:
            raise FileNotFound(path)
        self._check_lease(txn, target, client, path, takeover=True)
        tables = (_PPIS_READ_EMPTY if target["size"] == 0
                  else _PPIS_READ_FULL)
        self._file_scan(txn, tables, target["id"], EXCLUSIVE)
        node = dict(target)
        node["under_construction"], node["client"] = True, client
        txn.write("inode", node)
        self.lease_write(txn, client, node["id"])
        return node["id"]

    def append_file(self, path: str, *, client: str = "client") -> OpResult:
        comps = split_path(path)
        with self._begin(self._hint_for(comps, parent=False)) as txn:
            rp = self._resolve(
                txn, comps, last_lock=EXCLUSIVE, path=path,
                aux=(("lease", lambda p, t: (client,), READ_COMMITTED),))
            fid = self.append_apply(txn, rp.target, path, client=client)
            cost = txn.commit()
        return OpResult(fid, cost)

    def rename_file(self, src: str, dst: str) -> OpResult:
        """mv of a FILE. Changing parent changes the composite PK (and the
        shard), hence delete+insert inside one transaction. Directory renames
        go through the subtree protocol (subtree.py)."""
        sc, dc = split_path(src), split_path(dst)
        with self._begin(self._hint_for(sc, parent=True)) as txn:
            # total-order locking over both paths (§5 "Cyclic Deadlocks")
            first, second = (sc, dc) if sc <= dc else (dc, sc)
            r1 = self._resolve(txn, first, last_lock=EXCLUSIVE,
                               lock_parent=True, revalidate=True)
            r2 = self._resolve(txn, second, last_lock=EXCLUSIVE,
                               lock_parent=True)
            srp, drp = (r1, r2) if sc <= dc else (r2, r1)
            snode = srp.target
            if snode is None or snode["is_dir"]:
                raise FileNotFound(src)
            if drp.target is not None:
                raise FileAlreadyExists(dst)
            tables = (_PPIS_READ_EMPTY if snode["size"] == 0
                      else _PPIS_READ_FULL)
            self._file_scan(txn, tables, snode["id"], EXCLUSIVE)
            txn.delete("inode", (snode["parent_id"], snode["name"]))
            moved = dict(snode)
            moved["parent_id"], moved["name"] = drp.parent["id"], dc[-1]
            moved["mtime"] = next(self.clock)
            txn.write("inode", moved)
            dp = dict(drp.parent)
            dp["mtime"] = next(self.clock)
            txn.write("inode", dp)
            if srp.parent["id"] != drp.parent["id"]:
                sp = dict(srp.parent)
                sp["mtime"] = next(self.clock)
                txn.write("inode", sp)
            if self.cache:
                self.cache.invalidate(snode["parent_id"], snode["name"])
                self.cache.put(drp.parent["id"], dc[-1], snode["id"])
            cost = txn.commit()
        return OpResult(None, cost)

    def truncate(self, path: str, new_size: int = 0) -> OpResult:
        """HDFS-style truncate: drop every block fully beyond ``new_size``,
        shrink the boundary block, update the inode size.  Registered purely
        through the op registry — no namenode/DES dispatch edits (the
        extensibility proof for the typed operation protocol)."""
        if new_size < 0:
            raise FSError(f"negative truncate size {new_size}")
        comps = split_path(path)
        with self._begin(self._hint_for(comps, parent=False)) as txn:
            rp = self._resolve(
                txn, comps, last_lock=EXCLUSIVE, revalidate=True, path=path,
                aux=(("lease", lambda p, t:
                      ((t.get("client") or "client",) if t else None),
                      READ_COMMITTED),))
            node = rp.target
            if node is None or node["is_dir"]:
                raise FileNotFound(path)
            if new_size >= node["size"]:
                # nothing to drop; still a (cheap) committed no-op like HDFS
                cost = txn.commit()
                return OpResult({"size": node["size"], "removed_blocks": 0},
                                cost)
            related = self._file_scan(txn, _PPIS_TRUNC, node["id"],
                                      EXCLUSIVE)
            blocks = sorted(related.get("block", []),
                            key=lambda b: b["index"])
            reps = related.get("replica", [])
            removed = 0
            offset = 0
            for b in blocks:
                end = offset + b["size"]
                if offset >= new_size:           # fully beyond: drop block
                    txn.delete("block", (b["block_id"],))
                    for r in reps:
                        if r["block_id"] == b["block_id"]:
                            txn.delete("replica", (r["block_id"],
                                                   r["datanode_id"]))
                            txn.write("inv", {"block_id": b["block_id"],
                                              "datanode_id":
                                              r["datanode_id"],
                                              "inode_id": node["id"]})
                    removed += 1
                elif end > new_size:             # boundary block: shrink
                    nb = dict(b)
                    nb["size"] = new_size - offset
                    txn.write("block", nb)
                offset = end
            node = dict(node)
            node["size"] = new_size
            node["mtime"] = next(self.clock)
            txn.write("inode", node)
            cost = txn.commit()
        return OpResult({"size": new_size, "removed_blocks": removed}, cost)

    def concat(self, target: str, srcs: Sequence[str]) -> OpResult:
        """HDFS-style concat: move every source file's blocks onto the
        target (re-indexed after its existing blocks) and delete the source
        inodes, all in ONE transaction.  Block/replica rows are partitioned
        by inode id (§4.2), so re-owning a block is a delete+insert exactly
        like a rename across parents.  Paths are locked in total order
        (§5 "Cyclic Deadlocks")."""
        if not srcs:
            raise FSError("concat: no source files")
        if target in srcs:
            raise FSError("concat: target cannot be a source")
        if len(set(srcs)) != len(srcs):
            raise FSError("concat: duplicate source")
        tc = split_path(target)
        with self._begin(self._hint_for(tc, parent=False)) as txn:
            resolved: Dict[str, ResolvedPath] = {}
            ordered = sorted([target, *srcs], key=split_path)
            for i, p in enumerate(ordered):
                resolved[p] = self._resolve(txn, split_path(p),
                                            last_lock=EXCLUSIVE,
                                            lock_parent=True,
                                            revalidate=(i == 0), path=p)
            trp = resolved[target]
            tnode = trp.target
            if tnode is None or tnode["is_dir"]:
                raise FileNotFound(target)
            tblocks = sorted(
                self._file_scan(txn, ("block",), tnode["id"],
                                EXCLUSIVE).get("block", []),
                key=lambda b: b["index"])
            next_index = len(tblocks)
            moved = 0
            grown = 0
            touched_parents = {trp.parent["id"]}
            for src in srcs:
                srp = resolved[src]
                snode = srp.target
                if snode is None or snode["is_dir"]:
                    raise FileNotFound(src)
                related = self._file_scan(txn, _PPIS_CREATE_FULL,
                                          snode["id"], EXCLUSIVE)
                # partition-key update: the store relocates each row to the
                # target inode's shard (internal delete+insert, §4.2).
                # EVERY file-related row is re-owned — replica-state rows
                # (urb/prb/ruc/cr/er/inv) included — so deleting the source
                # inode orphans nothing.
                for b in sorted(related.pop("block", []),
                                key=lambda x: x["index"]):
                    nb = dict(b)
                    nb["inode_id"], nb["index"] = tnode["id"], next_index
                    txn.write("block", nb)
                    next_index += 1
                    moved += 1
                for tname, rws in related.items():
                    for r in rws:
                        nr = dict(r)
                        nr["inode_id"] = tnode["id"]
                        txn.write(tname, nr)
                txn.delete("inode", (snode["parent_id"], snode["name"]))
                grown += snode["size"]
                touched_parents.add(srp.parent["id"])
                if self.cache:
                    self.cache.invalidate(snode["parent_id"], snode["name"])
            tnode = dict(tnode)
            tnode["size"] += grown
            tnode["mtime"] = next(self.clock)
            txn.write("inode", tnode)
            for p in ordered:
                prow = resolved[p].parent
                if prow["id"] in touched_parents:
                    touched_parents.discard(prow["id"])
                    pr = dict(prow)
                    pr["mtime"] = next(self.clock)
                    txn.write("inode", pr)
            cost = txn.commit()
        return OpResult({"blocks_moved": moved, "size": tnode["size"]}, cost)

    # ------------------------------------------------------------------
    # block reports (§7.8)
    # ------------------------------------------------------------------
    def process_block_report(self, datanode_id: int,
                             block_ids: Sequence[int],
                             batch: int = 1000) -> OpResult:
        """Validate a datanode's blocks against the metadata: batched PK
        reads of block rows; replicas upserted; unknown blocks invalidated."""
        agg = OpCost()
        for i in range(0, len(block_ids), batch):
            chunk = block_ids[i:i + batch]
            with Transaction(self.store,
                             partition_hint=("block", chunk[0]),
                             distribution_aware=self.dat) as txn:
                got = txn.read_batch([("block", (b,), READ_COMMITTED)
                                      for b in chunk])
                for b, row in zip(chunk, got):
                    if row is None:
                        txn.write("inv", {"block_id": b,
                                          "datanode_id": datanode_id,
                                          "inode_id": -1})
                    else:
                        txn.write("replica", make_replica(
                            b, row["inode_id"], datanode_id))
                agg.merge(txn.commit())
        return OpResult(None, agg)
