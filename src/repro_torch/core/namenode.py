"""Stateless namenodes + client policies + the batched request pipeline.

A :class:`Namenode` is stateless apart from its inode hint cache: all
authoritative state lives in the :class:`~repro_torch.core.store.MetadataStore`.
Any number of namenodes serve the same store concurrently; clients pick one
per-op via *random*, *round-robin* or *sticky* policies and transparently
fail over to another namenode when one dies (§7.6.1 — this is why HopsFS has
no failover downtime).

Batched request pipeline (paper §2.2/§7.2): the throughput headline comes
from many namenodes issuing *batched, distribution-aware* transactions.
:class:`RequestPipeline` feeds N namenodes from one shared client queue in
fixed-size batches; :meth:`Namenode.execute_batch` groups consecutive
same-type read ops whose paths fully hit the hint cache, hashes every
hinted inode id to its partition in one vectorized ``phash`` kernel call
(§4.2), and validates each same-partition group's paths with ONE batched
PK exchange instead of 2-3 round trips per op. Mutating ops and cache
misses fall back to the sequential path, preserving exact sequential
semantics (asserted by tests/test_batched_pipeline.py).
"""
from __future__ import annotations

import random
import threading
import time
import warnings
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from .fs import (FSError, HopsFSOps, OpResult, SubtreeLockedError,
                 split_path)
from .leader import LeaderElection
from .middleware import (CallContext, compose, failover, subtree_retry,
                         txn_retry)
from .ops_registry import GroupWriteCtx, REGISTRY, WorkloadOp
from .store import (EXCLUSIVE, MetadataStore, OpCost, READ_COMMITTED,
                    SHARED, StoreError, _hash_key)
from .subtree import SubtreeOps
from .tables import ROOT_ID
from .transactions import Transaction

# read-only op types the batched executor may group (no mutation => any
# ordering within a run of them is equivalent to sequential execution).
# Derived from the op registry — the registry's `batchable` flag is the
# single source of truth; this name survives for importers as an
# import-time snapshot (live code paths consult REGISTRY directly, so ops
# registered later batch too).
BATCHABLE_READ_OPS = REGISTRY.batchable_ops()

#: mutation op names the grouped WRITE path may share a transaction across
#: (same import-time-snapshot convention as BATCHABLE_READ_OPS)
GROUP_MUTABLE_OPS = REGISTRY.group_mutable_ops()

# Below this many keys the scalar hash is used instead of a kernel launch
# (launch and transfer overhead dominate). The same gate as the JAX
# package, so kernel launches, and with them every count, stay equal.
PHASH_MIN_BATCH = 512


def _partitions_for(ids: Sequence[int], n_partitions: int, *,
                    device: Any, min_batch: int = PHASH_MIN_BATCH
                    ) -> List[int]:
    """Batch path->partition hashing: one ``phash`` launch on ``device``
    for a batch of at least ``min_batch`` keys, the scalar store hash
    below it. Both implement the identical mix, so placement always agrees
    with ``MetadataStore`` partitioning. A kernel error is raised, never
    hidden behind the scalar path."""
    if len(ids) < max(2, min_batch):
        return [_hash_key(i) % n_partitions for i in ids]
    from ..kernels.phash.ops import phash_partitions
    return [int(p) for p in phash_partitions(ids, n_partitions,
                                             device=device)]


@dataclass(frozen=True)
class PlanHint:
    """Client-side path resolution shipped with a planned batch (λFS-style
    client-side routing): the composite-PK chain of the op's path, the
    target inode id when the leaf resolved client-side, and the
    partition-hint inode id the planner grouped on. The executor treats
    these exactly like its own hint-cache output — validated against real
    rows inside the transaction, never trusted."""
    pks: Tuple[Tuple[int, str], ...]
    target_id: Optional[int]
    hint_id: int


@dataclass
class OpOutcome:
    """Per-op outcome from the batched pipeline: either a result or the
    name of the FS error that sequential execution would have raised."""
    result: Optional[OpResult]
    error: Optional[str] = None
    batched: bool = False

    @property
    def ok(self) -> bool:
        return self.result is not None


class Namenode:
    def __init__(self, store: MetadataStore, nn_id: int,
                 election: LeaderElection, **ops_kw):
        self.nn_id = nn_id
        self.store = store
        self.election = election
        # client leases are renewed/expired against the SAME logical clock
        # the election uses, so client death is detected exactly like
        # namenode death (bounded heartbeat staleness)
        ops_kw.setdefault("lease_now", lambda: election.now)
        self.ops = HopsFSOps(store, nn_id,
                             is_nn_alive=election.is_alive, **ops_kw)
        self.subtree = SubtreeOps(self.ops)
        self.alive = True
        #: chaos injection hook (chaos.FaultInjector.install); None = off.
        #: Sites fired here: "rpc" (perform/invoke), "batch_exchange"
        #: (execute_batch), "group_txn_pre_lock"/"group_txn_post_lock"
        #: (_write_group_txn) — see docs/CHAOS.md
        self.chaos: Optional[Any] = None
        #: admission-control hook (admission.AdmissionController.install);
        #: None = admit everything. Consulted AFTER the chaos site fires
        #: (a gray-slow exchange ages the clock first, THEN stale work is
        #: shed) — see docs/ROBUSTNESS.md
        self.admission: Optional[Any] = None
        self._in_batch = False   # suppress the rpc site for internal invokes
        self.ops_served = 0
        self.agg_cost = OpCost()     # committed-txn cost served by this NN
        self.batches_executed = 0
        self.batched_ops = 0
        self.batched_write_ops = 0   # mutations served by grouped txns
        # fused PK-validation telemetry (columnar backend only): grouped
        # read runs prevalidate their hint chains in one pkval launch
        self.pkval_launches = 0
        self.pkval_probes = 0
        self.pkval_demotions = 0
        # fused subtree/aggregation telemetry lives on ops + subtree;
        # see the treeagg_launches property below
        # prebuilt default retry chain — the batch hot path must not
        # recompose middleware per op. txn_retry sits inside: a lock
        # timeout under concurrent workers aborted atomically (§7.5), so
        # the op re-runs instead of surfacing a spurious failure
        self._safe_handler = compose([subtree_retry(), txn_retry()],
                                     lambda ctx: self.invoke(ctx.wop))

    @property
    def treeagg_launches(self) -> int:
        """Fused treeagg launches across this NN's two launch sites: the
        du aggregation (ops) and the phase-2 wave advisory (subtree)."""
        return self.ops.treeagg_launches + self.subtree.treeagg_launches

    def is_leader(self) -> bool:
        return self.election.leader() == self.nn_id

    def recover_leases(self) -> int:
        """Leader housekeeping (§3: "the leader runs ... lease recovery"):
        reclaim every lease whose holder stopped renewing for longer than
        the lease limit — clears under-construction state so another
        client's append/add_block can proceed. Only the leader runs this,
        mirroring §6.2's dead-namenode subtree-lock reclaim for clients.
        Returns the number of leases reclaimed."""
        if not self.alive or not self.is_leader():
            return 0
        reclaimed = 0
        for holder in self.ops.expired_lease_holders():
            try:
                res = self.ops.lease_recover(holder)
            except StoreError:
                # lock contention with the holder's own in-flight write
                # (it is evidently alive): skip — the next sweep re-scans
                continue
            self.agg_cost.merge(res.cost)
            if res.value is not None:    # None = renewed since the scan
                reclaimed += 1
        return reclaimed

    def scrub_leases(self) -> int:
        """Leader housekeeping twin of :meth:`recover_leases`: drop
        lease_path rows orphaned by file deletion (the model defers the
        HDFS LeaseManager's on-delete path removal to this sweep).
        Returns the number of rows scrubbed."""
        if not self.alive or not self.is_leader():
            return 0
        res = self.ops.scrub_leases()
        self.agg_cost.merge(res.cost)
        return res.value

    # -- response piggybacking (the closed-loop hint path) -------------
    def _piggyback_hints(self, paths: Sequence[str]
                         ) -> Tuple[Tuple[int, str, int], ...]:
        """The ``(parent_id, name) -> inode_id`` resolutions this
        namenode's hint cache holds for the op's path(s) AFTER execution
        — shipped back on every response (``OpResult.hints``) so client
        caches warm from responses instead of reading namenode caches.
        Pure in-memory peeks: charge-free, and post-execution state means
        a create's new inode rides its own response while a delete's
        victim (invalidated by the handler) never does."""
        cache = self.ops.cache
        if cache is None:
            return ()
        out: List[Tuple[int, str, int]] = []
        for p in paths:
            parent = ROOT_ID
            for name in split_path(p):
                child = cache.peek(parent, name)
                if child is None:
                    break
                out.append((parent, name, child))
                parent = child
        return tuple(out)

    def _finish_op(self, spec: Any, paths: Sequence[str],
                   kw: Dict[str, Any], res: OpResult) -> OpResult:
        """Post-execution RPC work shared by every entry point: account
        the op, piggyback the hint set onto the response, and refresh the
        executing client's lease stamp (piggybacked renewal — any op by a
        live holder is a heartbeat, ``HopsFSOps.touch_lease``)."""
        self.ops_served += 1
        self.agg_cost.merge(res.cost)
        if spec is not None and spec.destructive:
            # cross-client invalidation push: log the destroyed/moved
            # paths under a fresh store-wide hint epoch, so OTHER
            # clients' caches learn of them from their own next response
            # (concat's srcs are paths too, but arrive as a kwarg)
            self.store.record_hint_invalidation(
                list(paths) + [str(s) for s in kw.get("srcs", ()) or ()])
        res.hints = self._piggyback_hints(paths) + self.store.hint_piggyback()
        # goodput stamp: the election-clock tick this op finished at —
        # compared against WorkloadOp.deadline by the admission layer
        res.completed_at = self.election.now
        if spec is not None and spec.has_client_arg \
                and not spec.renews_lease and "client" in kw:
            # skipped for renews_lease ops: their handler already stamped
            # the lease inside its own transaction (lease_write)
            self.ops.touch_lease(kw["client"])
        return res

    # -- registry-dispatched execution ---------------------------------
    def perform(self, op: str, *args, **kw) -> OpResult:
        """Execute one op by registry name with explicit arguments — the
        canonical positional entry point (DFSClient and Client use it)."""
        if not self.alive:
            raise StoreError(f"namenode {self.nn_id} is down")
        if self.chaos is not None and not self._in_batch:
            self.chaos.fire("rpc", self.nn_id)
        spec = REGISTRY[op]
        res = spec.resolve(self)(*args, **kw)
        return self._finish_op(spec, [a for a in args[:spec.paths]
                                      if isinstance(a, str)], kw, res)

    def invoke(self, wop: WorkloadOp) -> OpResult:
        """Execute one :class:`WorkloadOp` record: the record's own
        ``args`` overlaid on the :class:`~.ops_registry.OpSpec` defaults,
        so workload-supplied arguments (perm, owner, repl, ...) flow
        end-to-end instead of being hardcoded here."""
        if not self.alive:
            raise StoreError(f"namenode {self.nn_id} is down")
        if self.chaos is not None and not self._in_batch:
            self.chaos.fire("rpc", self.nn_id)
        if self.admission is not None:
            # sequential-path admission: shed work already past its
            # deadline. Inside a batch this is a RE-check (the batch was
            # admitted as a whole, but a mid-batch group txn may have
            # burned clock) — record=False avoids double accounting
            self.admission.check_op(wop, record=not self._in_batch)
        spec = REGISTRY[wop.op]
        paths, kw = spec.call_args(wop)
        res = spec.resolve(self)(*paths, **kw)
        return self._finish_op(spec, paths, kw, res)

    # -- deprecated string-dispatch shims ------------------------------
    def execute(self, op: str, *args, **kw) -> OpResult:
        """Deprecated: use :meth:`perform` (or the ``DFSClient`` facade)."""
        warnings.warn("Namenode.execute(op, ...) is deprecated; use "
                      "Namenode.perform or the DFSClient facade",
                      DeprecationWarning, stacklevel=2)
        return self.perform(op, *args, **kw)

    def execute_wop(self, wop: WorkloadOp) -> OpResult:
        """Deprecated: use :meth:`invoke`."""
        warnings.warn("Namenode.execute_wop(wop) is deprecated; use "
                      "Namenode.invoke", DeprecationWarning, stacklevel=2)
        return self.invoke(wop)

    # ------------------------------------------------------------------
    # batched execution (pipeline hot path)
    # ------------------------------------------------------------------
    def _safe_exec(self, wop: WorkloadOp, *, retries: int = 8,
                   backoff: float = 0.002) -> OpOutcome:
        """Execute one op, mapping FS errors to outcomes. Ops that hit a
        live subtree lock voluntarily aborted (§6.3) — retried with backoff
        by the shared ``subtree_retry`` middleware, exactly as the HopsFS
        client does, instead of failing."""
        if (retries, backoff) == (8, 0.002):
            handler = self._safe_handler      # hot path: prebuilt chain
        else:
            handler = compose(
                [subtree_retry(retries=retries, backoff=backoff),
                 txn_retry()],
                lambda ctx: self.invoke(ctx.wop))
        try:
            return OpOutcome(handler(CallContext(op=wop.op, wop=wop,
                                                 namenode=self)))
        except StoreError as e:      # includes surfaced SubtreeLockedError
            return OpOutcome(None, type(e).__name__)

    def execute_batch(self, wops: Sequence[WorkloadOp],
                      hints: Optional[Sequence[Optional[PlanHint]]] = None
                      ) -> List[OpOutcome]:
        """Execute a pulled batch. Maximal runs of consecutive same-type
        groupable ops are executed through the grouped paths — batchable
        reads via one shared transaction per partition group, group-mutable
        mutations via one shared run transaction with total-order locking
        and submission-order execute phases — and everything else runs
        through the exact sequential path, in order. Either way the store
        ends in the same state as strictly sequential execution of the
        batch. ``hints`` optionally carries the planner's client-side path
        resolutions (one entry per op, None where unplanned)."""
        if not self.alive:
            raise StoreError(f"namenode {self.nn_id} is down")
        if self.chaos is not None:
            self.chaos.fire("batch_exchange", self.nn_id)
        # ops inside the batch share THIS exchange: the per-op rpc site
        # must not fire again for internal invokes
        self._in_batch = True
        try:
            if self.admission is None:
                return self._execute_batch_inner(wops, hints)
            # batch admission AFTER the exchange's chaos site: a gray-slow
            # exchange ages the clock first, so work that expired while
            # this namenode limped is shed here instead of executed
            decisions = self.admission.admit_batch(wops)
            results: List[Optional[OpOutcome]] = [
                None if d is None else OpOutcome(None, d, batched=True)
                for d in decisions]
            keep = [i for i, d in enumerate(decisions) if d is None]
            if keep:
                sub = [wops[i] for i in keep]
                subh = ([hints[i] for i in keep]
                        if hints is not None else None)
                for i, oc in zip(keep, self._execute_batch_inner(sub, subh)):
                    results[i] = oc
            return results  # type: ignore[return-value]
        finally:
            self._in_batch = False

    def _execute_batch_inner(self, wops: Sequence[WorkloadOp],
                             hints: Optional[Sequence[Optional[PlanHint]]]
                             ) -> List[OpOutcome]:
        results: List[Optional[OpOutcome]] = [None] * len(wops)
        i = 0
        while i < len(wops):
            op = wops[i].op
            j = i + 1
            spec = REGISTRY.get(op)
            groupable = spec is not None and (
                spec.batchable
                or (spec.group_mutable and spec.group_apply is not None))
            if groupable:                             # live registry check
                while j < len(wops) and wops[j].op == op:
                    j += 1
                if j - i > 1:
                    if spec.batchable:
                        self._execute_read_run(op, wops, i, j, results,
                                               hints)
                    else:
                        self._execute_write_run(op, wops, i, j, results,
                                                hints)
                else:
                    results[i] = self._safe_exec(wops[i])
            else:
                results[i] = self._safe_exec(wops[i])
            i = j
        self.batches_executed += 1
        # response piggybacking for the GROUPED outcomes (the sequential
        # path attaches hints in invoke): ship back the hint-cache state
        # the grouped transactions repaired, and refresh the executing
        # clients' lease stamps (any op by a live holder is a heartbeat —
        # once per DISTINCT client, not per op: all stamps in one batch
        # share the same logical tick, so N touches of one hot client
        # would just be N redundant lock round trips)
        clients: Set[str] = set()
        for wop, oc in zip(wops, results):
            if oc is None or not oc.ok or not oc.batched:
                continue
            spec = REGISTRY.get(wop.op)
            if spec is None:
                continue
            paths, kw = spec.call_args(wop)
            oc.result.hints = self._piggyback_hints(paths) \
                + self.store.hint_piggyback()
            if spec.has_client_arg and not spec.renews_lease \
                    and "client" in kw:
                clients.add(kw["client"])
        for client in sorted(clients):
            self.ops.touch_lease(client)
        return results  # type: ignore[return-value]

    def _execute_read_run(self, op: str, wops: Sequence[WorkloadOp],
                          lo: int, hi: int,
                          results: List[Optional[OpOutcome]],
                          hints: Optional[Sequence[Optional[PlanHint]]]
                          = None) -> None:
        """A run of same-type read ops: ops whose full path chain hits the
        hint cache (or arrived with a planner hint) are grouped by target
        partition (vectorized phash over the hinted inode ids) and executed
        one shared transaction per partition group; cache misses fall back
        to the sequential path."""
        cache = self.ops.cache
        hits: List[Tuple[int, List[str], List[Tuple[int, str]], int]] = []
        for idx in range(lo, hi):
            comps = split_path(wops[idx].path)
            resolved = (cache.resolve_pks_and_id(comps)
                        if (cache is not None and comps) else None)
            if resolved is None and hints is not None and comps:
                h = hints[idx]
                if h is not None and h.target_id is not None:
                    resolved = (list(h.pks), h.target_id)
            if resolved is None:
                results[idx] = self._safe_exec(wops[idx])
            else:
                pks, tid = resolved
                hits.append((idx, comps, pks, tid))
        hits = self._prevalidate_hits(wops, hits, results)
        if not hits:
            return
        parts = _partitions_for([h[3] for h in hits],
                                self.ops.store.n_partitions,
                                device=self.store.device)
        groups: Dict[int, List[Tuple[int, List[str],
                                     List[Tuple[int, str]], int]]] = {}
        for h, p in zip(hits, parts):
            groups.setdefault(p, []).append(h)
        for _, group in sorted(groups.items()):
            self._read_group_txn(op, wops, group, results)

    def _prevalidate_hits(self, wops: Sequence[WorkloadOp],
                          hits: List[Tuple[int, List[str],
                                           List[Tuple[int, str]], int]],
                          results: List[Optional[OpOutcome]]
                          ) -> List[Tuple[int, List[str],
                                          List[Tuple[int, str]], int]]:
        """Grouped-batch PK validation of a read run's hint chains: ONE
        fused pkval launch against the columnar store's hash index, stale
        chains demoted to the exact sequential path BEFORE they waste a
        grouped round trip. A no-op on the dict backend (no hash index)
        and below the kernel's batch gate — purely advisory either way,
        since in-transaction validation still guards every grouped read."""
        if not hits:
            return hits
        from .columnar import prevalidate_chains
        out = prevalidate_chains(
            self.ops.store, [(h[2], h[3]) for h in hits])
        if out is None:
            return hits
        ok_flags, probes, used = out
        if probes:
            self.pkval_probes += probes
            if used:
                self.pkval_launches += 1
        kept = []
        for h, ok in zip(hits, ok_flags):
            if ok:
                kept.append(h)
            else:
                self.pkval_demotions += 1
                results[h[0]] = self._safe_exec(wops[h[0]])
        return kept

    def _commit_group(self, txn: Transaction, order: Sequence[int],
                      values: Dict[int, Any], op_costs: Dict[int, OpCost],
                      errors: Dict[int, str], accounted: OpCost,
                      results: List[Optional[OpOutcome]], *,
                      writes: bool = False) -> None:
        """Commit a grouped transaction and attribute its cost per op —
        the single source of the conserved-accounting invariant for BOTH
        the grouped read and grouped write paths: each op keeps its own
        ``OpCost.diff`` share; the shared validation batch, commit flush,
        and any reads done for ops that errored or fell back are charged
        to the FIRST successful op, so Σ outcome costs == the cost
        aggregated per namenode. (Like the sequential path, the cost of a
        transaction that served no op at all is dropped.)"""
        total = txn.commit()
        unattributed = total.diff(accounted)
        served = OpCost()
        first_done = True
        for idx in order:
            if idx in values:
                cost = op_costs[idx]
                if first_done:
                    cost.merge(unattributed)
                    first_done = False
                results[idx] = OpOutcome(
                    OpResult(values[idx], cost,
                             completed_at=self.election.now),
                    batched=True)
                served.merge(cost)
                self.ops_served += 1
                self.batched_ops += 1
                if writes:
                    self.batched_write_ops += 1
            elif idx in errors:
                results[idx] = OpOutcome(None, errors[idx], batched=True)
        self.agg_cost.merge(served)

    def _read_group_txn(self, op: str, wops: Sequence[WorkloadOp],
                        group: Sequence[Tuple[int, List[str],
                                              List[Tuple[int, str]], int]],
                        results: List[Optional[OpOutcome]]) -> None:
        """One shared distribution-aware transaction for a same-partition
        group: ONE batched exchange validates every op's ancestor chain,
        lock-reads every target, and folds in the dependent lease reads;
        per-op file scans then run inside the same transaction. Stale hints
        are invalidated and the op re-runs sequentially (§5.1.1)."""
        fsops = self.ops
        spec = REGISTRY[op]
        fallback: List[int] = []
        try:
            txn = Transaction(fsops.store,
                              partition_hint=("inode", group[0][3]),
                              distribution_aware=fsops.dat)
        except StoreError:
            for idx, *_ in group:
                results[idx] = self._safe_exec(wops[idx])
            return
        try:
            per_op: Dict[int, Tuple[bool, List[Dict[str, Any]],
                                    Optional[Dict[str, Any]], int]] = {}
            with txn.batch() as b:
                for idx, comps, pks, _tid in group:
                    got: List[Dict[str, Any]] = []
                    ok = True
                    parent = ROOT_ID
                    for pk in pks[:-1]:
                        r = b.read("inode", pk, READ_COMMITTED)
                        if r is None or pk[0] != parent:
                            ok = False
                            break
                        got.append(r)
                        parent = r["id"]
                    target = None
                    if ok:
                        target = b.read("inode", (parent, comps[-1]), SHARED)
                        if target is not None and spec.lease_read:
                            # dependent lease read, same exchange (§5.1)
                            b.read("lease",
                                   (target.get("client") or "client",),
                                   READ_COMMITTED)
                    per_op[idx] = (ok, got, target, parent)
            op_costs: Dict[int, OpCost] = {}
            values: Dict[int, Any] = {}
            errors: Dict[int, str] = {}
            accounted = OpCost()
            for idx, comps, pks, _tid in group:
                ok, ancestors, target, parent_id = per_op[idx]
                if not ok or target is None:
                    # stale hints (rename/delete moved a row): repair + redo
                    if cachev := fsops.cache:
                        for pk in pks:
                            cachev.invalidate(*pk)
                    fallback.append(idx)
                    continue
                before = txn.cost.copy()
                try:
                    values[idx] = spec.batch_payload(fsops, txn, target)
                    for row in ancestors:
                        fsops._check_subtree_lock(row, txn)
                    fsops._check_subtree_lock(target, txn)
                    if fsops.cache:
                        # repair under the VALIDATED ids — a recreated
                        # ancestor keeps its composite PK but gets a new
                        # inode id, and the hinted ids may be stale
                        for pk, row in zip(pks, ancestors):
                            fsops.cache.put(pk[0], pk[1], row["id"])
                        fsops.cache.put(parent_id, comps[-1], target["id"])
                    op_costs[idx] = txn.cost.diff(before)
                    accounted.merge(op_costs[idx])
                except SubtreeLockedError:
                    # voluntary abort (§6.3): re-run sequentially w/ retry
                    values.pop(idx, None)
                    fallback.append(idx)
                except StoreError as e:
                    errors[idx] = type(e).__name__
                    values.pop(idx, None)
            self._commit_group(txn, [idx for idx, *_ in group], values,
                               op_costs, errors, accounted, results)
        except StoreError:
            txn.abort()
            fallback = [idx for idx, *_ in group]
        for idx in fallback:
            results[idx] = self._safe_exec(wops[idx])

    # ------------------------------------------------------------------
    # grouped WRITE path (§5 three-phase template shared across a run)
    # ------------------------------------------------------------------
    def _execute_write_run(self, op: str, wops: Sequence[WorkloadOp],
                           lo: int, hi: int,
                           results: List[Optional[OpOutcome]],
                           hints: Optional[Sequence[Optional[PlanHint]]]
                           = None) -> None:
        """A run of same-type group-mutable mutations: ops whose ancestor
        chain resolves (hint cache, else planner hints) share ONE
        transaction whose coordinator lands on the partition most ops in
        the run hash to (vectorized phash — for planner-aligned batches the
        whole run shares that partition, so the DAT hint is exact).
        Execute phases apply in submission order, so grouped execution
        stays observably identical to sequential execution; everything
        unresolvable falls back to the sequential path, in order.

        Lease-ordered block writes (add_block/append/complete_block) ride
        this same path: submission-order execute phases serialize each
        file's block mutations behind its lease (block indices and
        under-construction state stay exactly sequential) while distinct
        files — distinct lease keys — batch freely in one transaction."""
        cache = self.ops.cache
        spec = REGISTRY[op]
        segment: List[Tuple[int, List[str], List[Tuple[int, str]], int,
                            Dict[str, Any]]] = []

        def flush_segment() -> None:
            if not segment:
                return
            items = list(segment)
            segment.clear()
            parts = _partitions_for([it[3] for it in items],
                                    self.ops.store.n_partitions,
                                    device=self.store.device)
            counts: Dict[int, int] = {}
            for p in parts:
                counts[p] = counts.get(p, 0) + 1
            coord = max(counts, key=lambda p: (counts[p], -p))
            hint_key = items[parts.index(coord)][3]
            fallback: List[int] = []
            self._write_group_txn(spec, wops, items, hint_key, results,
                                  fallback)
            for i in sorted(set(fallback)):
                if results[i] is None:
                    results[i] = self._safe_exec(wops[i])

        # the run is split into maximal SEGMENTS of consecutive resolvable
        # ops: a cache-miss op executes sequentially AT ITS SUBMISSION
        # POSITION (after the segment before it, before everything after),
        # so resolvability differences can never reorder mutations
        for idx in range(lo, hi):
            wop = wops[idx]
            comps = split_path(wop.path)
            resolved: Optional[Tuple[List[Tuple[int, str]], int]] = None
            if comps and cache is not None:
                if spec.hint == "parent":
                    pks = cache.resolve_pks(comps)
                    if pks is not None:
                        resolved = (pks, pks[-1][0])
                else:
                    resolved = cache.resolve_pks_and_id(comps)
            if resolved is None and hints is not None and comps:
                h = hints[idx]
                if h is not None:
                    resolved = (list(h.pks), h.hint_id)
            if resolved is None:
                flush_segment()
                results[idx] = self._safe_exec(wop)
            else:
                _, kw = spec.call_args(wop)
                segment.append((idx, comps, resolved[0], resolved[1], kw))
        flush_segment()

    def _write_group_txn(self, spec: Any, wops: Sequence[WorkloadOp],
                         items: Sequence[Tuple[int, List[str],
                                               List[Tuple[int, str]], int,
                                               Dict[str, Any]]],
                         hint_key: int,
                         results: List[Optional[OpOutcome]],
                         fallback: List[int]) -> None:
        """One shared distribution-aware transaction for a run of
        mutations, following the Fig 4 template across the whole group:

        LOCK    — ONE batched exchange: every op's ancestor chain at
                  read-committed, then every op's exclusive (parent,
                  target) locks in GLOBAL root-down path order (§5 "Cyclic
                  Deadlocks" — two namenodes grouping overlapping paths
                  acquire in the same order), then the dependent aux reads
                  (lease/quota) of the ops' lock phases. Lease rows are
                  only X-locked at write time, AFTER the holder's file
                  inode lock — so lease-lock order is derived from the
                  global inode-lock order and cannot deadlock either.
        EXECUTE — per-op ``group_apply`` (the same fs.py apply helpers the
                  sequential handlers run) in SUBMISSION order, on
                  cache-fresh rows, so ops in one group observe each
                  other exactly as sequential execution interleaves them.
        UPDATE  — one commit flushes every op's dirty rows; per-op cost
                  attributed via ``OpCost.diff`` snapshots, the shared
                  validation/commit cost to the first successful op.

        Stale hints are invalidated and the op re-runs sequentially
        (§5.1.1); a transaction-level failure aborts (discarding every
        in-cache effect) and the whole group re-runs sequentially."""
        fsops = self.ops
        lock_parent = spec.hint == "parent"
        root_pk = (0, "")
        try:
            txn = Transaction(fsops.store,
                              partition_hint=("inode", hint_key),
                              distribution_aware=fsops.dat)
        except StoreError:
            fallback.extend(idx for idx, *_ in items)
            return
        try:
            if self.chaos is not None:     # crash before any lock is taken
                self.chaos.fire("group_txn_pre_lock", self.nn_id)
            chains: Dict[int, Tuple[bool, List[Dict[str, Any]], int]] = {}
            rows: Dict[Tuple[int, str],
                       Tuple[Tuple[int, str],
                             Optional[Dict[str, Any]]]] = {}
            with txn.batch() as b:
                for idx, comps, pks, _hint, kw in items:
                    ok = True
                    got: List[Dict[str, Any]] = []
                    parent = ROOT_ID
                    for pk in pks[:-1]:
                        r = b.read("inode", pk, READ_COMMITTED)
                        if r is None or pk[0] != parent:
                            ok = False
                            break
                        got.append(r)
                        parent = r["id"]
                    chains[idx] = (ok, got, parent)
                # exclusive locks for every op, globally sorted root-down
                lock_list: List[Tuple[Tuple[str, ...], Tuple[int, str],
                                      int, str]] = []
                for idx, comps, pks, _hint, kw in items:
                    ok, _got, parent_id = chains[idx]
                    if not ok:
                        continue
                    if lock_parent:
                        ppk = pks[-2] if len(pks) >= 2 else root_pk
                        lock_list.append((tuple(comps[:-1]), ppk, idx,
                                          "parent"))
                    lock_list.append((tuple(comps),
                                      (parent_id, comps[-1]), idx,
                                      "target"))
                for path_key, pk, idx, kind in sorted(
                        lock_list, key=lambda e: e[0]):
                    rows[(idx, kind)] = (pk, b.read("inode", pk, EXCLUSIVE))
                if spec.group_aux is not None:
                    for idx, comps, pks, _hint, kw in items:
                        ok, _got, parent_id = chains[idx]
                        if not ok:
                            continue
                        target = rows[(idx, "target")][1]
                        for tname, pk, lk in spec.group_aux(kw, parent_id,
                                                            target):
                            b.read(tname, pk, lk)
            if self.chaos is not None:     # crash HOLDING the group's locks
                self.chaos.fire("group_txn_post_lock", self.nn_id)
            # ---- validation + subtree checks + cache repair ------------
            valid: List[Tuple[int, List[str], Dict[str, Any],
                              Tuple[int, str], Tuple[int, str]]] = []
            for idx, comps, pks, _hint, kw in items:
                ok, got, parent_id = chains[idx]
                parent_pk = (pks[-2] if len(pks) >= 2 else root_pk)
                if ok and lock_parent and rows[(idx, "parent")][1] is None:
                    ok = False
                if not ok:
                    if cachev := fsops.cache:
                        for pk in pks:
                            cachev.invalidate(*pk)
                    fallback.append(idx)
                    continue
                target_pk, target = rows[(idx, "target")]
                try:
                    for row in got:
                        fsops._check_subtree_lock(row, txn)
                    if lock_parent:
                        fsops._check_subtree_lock(rows[(idx, "parent")][1],
                                                  txn)
                    if target is not None:
                        fsops._check_subtree_lock(target, txn)
                except SubtreeLockedError:
                    fallback.append(idx)        # voluntary abort (§6.3)
                    continue
                if fsops.cache:
                    # repair under the VALIDATED ids (cf. the read path)
                    for pk, row in zip(pks, got):
                        fsops.cache.put(pk[0], pk[1], row["id"])
                    if target is not None:
                        fsops.cache.put(parent_id, comps[-1], target["id"])
                valid.append((idx, comps, kw, parent_pk, target_pk))
            # ---- EXECUTE phase, strictly in submission order -----------
            op_costs: Dict[int, OpCost] = {}
            values: Dict[int, Any] = {}
            errors: Dict[int, str] = {}
            accounted = OpCost()
            for idx, comps, kw, parent_pk, target_pk in sorted(valid):
                parent_row = txn.peek("inode", parent_pk)
                target_row = txn.peek("inode", target_pk)
                before = txn.cost.copy()
                before_dirty = len(txn.dirty)
                try:
                    ctx = GroupWriteCtx(parent=parent_row,
                                        target=target_row,
                                        comps=list(comps),
                                        path=wops[idx].path, kw=kw)
                    values[idx] = spec.group_apply(fsops, txn, ctx)
                    op_costs[idx] = txn.cost.diff(before)
                    accounted.merge(op_costs[idx])
                except SubtreeLockedError:
                    # apply helpers check before writing, so a clean raise
                    # leaves no trace; anything that DID write must not be
                    # half-committed — abort the whole group instead
                    # (sequential execution aborts that op's transaction)
                    if len(txn.dirty) != before_dirty:
                        raise
                    fallback.append(idx)
                except StoreError as e:
                    if len(txn.dirty) != before_dirty:
                        raise
                    errors[idx] = type(e).__name__
            self._commit_group(txn, [idx for idx, *_ in items], values,
                               op_costs, errors, accounted, results,
                               writes=True)
        except StoreError:
            # transaction-level failure: discard every in-cache effect and
            # re-run the whole group sequentially
            txn.abort()
            fallback.extend(idx for idx, *_ in items)
            for idx, *_ in items:
                results[idx] = None


class NamenodeCluster:
    """A fleet of stateless namenodes over one store, plus the election.

    ``auto_lease_recovery=True`` makes every heartbeat round also run the
    leader's lease-recovery housekeeping (production behaviour); the
    default keeps recovery explicit (:meth:`recover_leases`) so
    state-equivalence tests control exactly when store state changes."""

    def __init__(self, store: MetadataStore, n_namenodes: int, *,
                 auto_lease_recovery: bool = False, **ops_kw):
        self.store = store
        self.election = LeaderElection(store)
        self.auto_lease_recovery = auto_lease_recovery
        # kept for elastic membership: add_namenode builds late joiners
        # with the same ops configuration the founders got (copied per
        # namenode — Namenode.__init__ setdefaults into the dict)
        self._ops_kw = dict(ops_kw)
        self.namenodes = [Namenode(store, i, self.election, **ops_kw)
                          for i in range(n_namenodes)]
        for nn in self.namenodes:
            self.election.heartbeat(nn.nn_id)

    def tick(self) -> None:
        """One heartbeat round: alive namenodes prove liveness."""
        self.election.tick()
        for nn in self.namenodes:
            if nn.alive:
                self.election.heartbeat(nn.nn_id)
        if self.auto_lease_recovery:
            self.recover_leases()

    def recover_leases(self) -> int:
        """Run the leader's lease-recovery housekeeping once."""
        ldr = self.leader()
        return ldr.recover_leases() if ldr is not None else 0

    def scrub_leases(self) -> int:
        """Run the leader's orphaned-lease-path scrub once."""
        ldr = self.leader()
        return ldr.scrub_leases() if ldr is not None else 0

    def kill(self, nn_id: int) -> None:
        self.namenodes[nn_id].alive = False

    def restart(self, nn_id: int) -> None:
        self.namenodes[nn_id].alive = True
        self.election.heartbeat(nn_id)

    # -- elastic membership (the ElasticNamenodePool's substrate) -------
    def add_namenode(self, **ops_kw) -> Namenode:
        """Scale-out: append a fresh stateless namenode (ids are list
        indices, so new members always take ``len(namenodes)``), register
        it with the election, and — if a chaos injector is attached to the
        fleet — extend the injector to it (faults must be able to strike
        late joiners too). The caller (the pool) pre-warms its hint cache
        BEFORE the next batch is dealt, so it never serves cold."""
        kw = dict(self._ops_kw)
        kw.update(ops_kw)
        nn = Namenode(self.store, len(self.namenodes), self.election, **kw)
        donor = next((m for m in self.namenodes if m.chaos is not None),
                     None)
        if donor is not None:
            nn.chaos = donor.chaos
            nn.subtree.chaos = donor.subtree.chaos
        self.namenodes.append(nn)
        self.election.heartbeat(nn.nn_id)
        return nn

    def retire(self, nn_id: int) -> None:
        """Scale-in: stop serving AND leave the election immediately
        (``LeaderElection.remove`` deletes the heartbeat row, so the
        leader role moves this tick instead of after the staleness bound —
        a retirement is planned, unlike a crash). The slot stays in
        ``namenodes`` (ids are indices); ``alive_namenodes`` excludes it."""
        self.namenodes[nn_id].alive = False
        self.election.remove(nn_id)

    def alive_namenodes(self) -> List[Namenode]:
        return [nn for nn in self.namenodes if nn.alive]

    def leader(self) -> Optional[Namenode]:
        lid = self.election.leader()
        return self.namenodes[lid] if lid is not None else None


class Client:
    """HopsFS client with namenode selection policies (§3) and transparent
    retry on namenode failure (§7.6.1) or subtree-lock conflicts (§6.3) —
    both implemented by the shared :mod:`~repro_torch.core.middleware` stack the
    ``DFSClient`` facade uses."""

    def __init__(self, cluster: NamenodeCluster, policy: str = "sticky",
                 seed: int = 0, board: Any = None):
        assert policy in ("random", "round_robin", "sticky")
        self.cluster = cluster
        self.policy = policy
        self.rng = random.Random(seed)
        self._rr = self.rng.randrange(1 << 16)
        self._sticky: Optional[int] = None
        self.retries = 0
        #: optional admission.BreakerBoard — selection avoids namenodes
        #: whose circuit breaker is open (unless every breaker is open,
        #: in which case routing proceeds and the breakers re-probe)
        self.board = board

        def _on_failover(ctx: CallContext) -> None:
            self._sticky = None

        self._middleware = [failover(on_failover=_on_failover),
                            subtree_retry(backoff=0.0)]

    def _pick(self) -> Namenode:
        alive = self.cluster.alive_namenodes()
        if not alive:
            raise StoreError("no alive namenodes")
        if self.board is not None:
            # breaker-aware: don't route at a tripped namenode; if the
            # whole fleet tripped, fall through (half-open probes heal)
            routable = [nn for nn in alive
                        if self.board.routable(nn.nn_id)]
            alive = routable or alive
        if self.policy == "random":
            return self.rng.choice(alive)
        if self.policy == "round_robin":
            nn = alive[self._rr % len(alive)]
            self._rr += 1
            return nn
        # sticky: stay with one namenode (better hint-cache locality §5.1.1)
        if self._sticky is not None and not any(
                nn.nn_id == self._sticky for nn in alive):
            self._sticky = None          # dead OR breaker-open: re-pick
        if self._sticky is None:
            self._sticky = self.rng.choice(alive).nn_id
        return self.cluster.namenodes[self._sticky]

    def execute(self, op: str, *args, **kw) -> OpResult:
        def terminal(ctx: CallContext) -> OpResult:
            nn = self._pick()
            ctx.namenode = nn
            ctx.attempts += 1
            return nn.perform(op, *args, **kw)

        ctx = CallContext(op=op)
        try:
            return compose(self._middleware, terminal)(ctx)
        finally:
            self.retries += ctx.retries


# ---------------------------------------------------------------------------
# batched multi-namenode request pipeline
# ---------------------------------------------------------------------------


@dataclass
class PipelineStats:
    """Result of one :class:`RequestPipeline` run. ``per_nn_cost`` is each
    namenode's committed-transaction cost during this run; the pipeline
    conserves accounting: merging ``per_nn_cost`` over namenodes equals
    ``total_cost`` equals the merge of every successful outcome's cost."""
    outcomes: List[OpOutcome]
    per_nn_cost: Dict[int, OpCost]
    per_nn_ops: Dict[int, int]
    total_cost: OpCost
    ok: int
    failed: int
    wall_s: float
    batch_size: int
    n_batches: int
    batched_read_ops: int = 0     # read-only ops served by grouped txns
    batched_write_ops: int = 0    # mutations served by grouped txns

    @property
    def throughput(self) -> float:
        return self.ok / self.wall_s if self.wall_s else 0.0

    @property
    def batched_fraction(self) -> float:
        if not self.outcomes:
            return 0.0
        return sum(1 for o in self.outcomes if o.batched) / len(self.outcomes)

    @property
    def batched_read_fraction(self) -> float:
        """Share of ops served by a grouped READ transaction."""
        return self.batched_read_ops / len(self.outcomes) \
            if self.outcomes else 0.0

    @property
    def batched_write_fraction(self) -> float:
        """Share of ops served by a grouped WRITE transaction — zero before
        the grouped write path existed, so batched_fraction strictly above
        batched_read_fraction is the write path engaging."""
        return self.batched_write_ops / len(self.outcomes) \
            if self.outcomes else 0.0

    @property
    def local_rt_fraction(self) -> float:
        """Share of DB round trips answered by the transaction
        coordinator's own node group (DAT effectiveness, §7.7)."""
        loc = self.total_cost.local_rt
        tot = loc + self.total_cost.remote_rt
        return loc / tot if tot else 0.0


class RequestPipeline:
    """Shared client queue feeding a fleet of namenodes in fixed batches.

    ``concurrent=False`` drains the queue round-robin on the calling thread
    — fully deterministic (ops execute in submission order regardless of
    namenode count or batch size), which is what the state-equivalence
    tests rely on. ``concurrent=True`` runs one worker thread per alive
    namenode against the same queue, exercising real row-lock contention
    on the shared store.

    ``hint_routing=True`` (the elastic-fleet mode) replaces blind
    round-robin dealing with hint-aware routing: a batch goes to the
    namenode whose inode hint cache already resolves its first op's path
    (side-effect-free peeks), falling back to round-robin when nobody is
    warm. On a static fleet the partition hash already gives stable
    affinity, so this stays off by default — it matters when membership
    changes mid-run and the warm cache IS the routing signal."""

    def __init__(self, cluster: NamenodeCluster, *, batch_size: int = 16,
                 concurrent: bool = False, hint_routing: bool = False):
        self.cluster = cluster
        self.batch_size = max(1, batch_size)
        self.concurrent = concurrent
        self.hint_routing = hint_routing

    @staticmethod
    def _warm_namenode(path: str, alive: Sequence[Namenode]
                       ) -> Optional[Namenode]:
        """First alive namenode whose hint cache resolves ``path``'s full
        component chain — pure peeks, so routing probes never skew any
        namenode's own cache statistics."""
        comps = split_path(path)
        if not comps:
            return None
        for nn in alive:
            cache = nn.ops.cache
            if cache is None:
                continue
            parent: Optional[int] = ROOT_ID
            for name in comps:
                parent = cache.peek(parent, name)
                if parent is None:
                    break
            if parent is not None:
                return nn
        return None

    def run(self, wops: Sequence[WorkloadOp]) -> PipelineStats:
        wops = list(wops)
        outcomes: List[Optional[OpOutcome]] = [None] * len(wops)
        q: deque = deque(range(len(wops)))
        qlock = threading.Lock()
        n_batches = [0]
        alive = self.cluster.alive_namenodes()
        if not alive:
            raise StoreError("no alive namenodes")
        cost0 = {nn.nn_id: nn.agg_cost.copy()
                 for nn in self.cluster.namenodes}
        served0 = {nn.nn_id: nn.ops_served for nn in self.cluster.namenodes}

        def pull() -> List[int]:
            with qlock:
                k = min(self.batch_size, len(q))
                return [q.popleft() for _ in range(k)]

        def requeue(idxs: List[int]) -> None:
            with qlock:
                q.extendleft(reversed(idxs))

        def run_one(nn: Namenode, idxs: List[int]) -> bool:
            """One batch on one namenode; False if the NN died mid-run (the
            batch is requeued for the survivors — §7.6.1 failover)."""
            try:
                res = nn.execute_batch([wops[i] for i in idxs])
            except StoreError:
                requeue(idxs)
                return False
            retry: List[int] = []
            for i, oc in zip(idxs, res):
                if not oc.ok and oc.error == "StoreError" and not nn.alive:
                    # op was in flight when this NN died: fail over (§7.6.1)
                    retry.append(i)
                else:
                    outcomes[i] = oc
            if retry:
                requeue(retry)
            with qlock:
                n_batches[0] += 1
            return not retry

        def drain(nn: Namenode) -> None:
            while True:
                idxs = pull()
                if not idxs:
                    return
                if not run_one(nn, idxs):
                    return

        t0 = time.perf_counter()
        if self.concurrent:
            # re-drain with the survivors if a dying namenode requeued its
            # batch after the other workers already saw an empty queue
            while True:
                live = self.cluster.alive_namenodes()
                with qlock:
                    pending = bool(q)
                if not pending or not live:
                    break
                workers = [threading.Thread(target=drain, args=(nn,))
                           for nn in live]
                for w in workers:
                    w.start()
                for w in workers:
                    w.join()
        else:
            rr = 0
            while q:
                alive = self.cluster.alive_namenodes()
                if not alive:
                    break
                idxs = pull()
                nn = alive[rr % len(alive)]
                rr += 1
                if self.hint_routing and idxs and len(alive) > 1:
                    warm = self._warm_namenode(wops[idxs[0]].path, alive)
                    if warm is not None:
                        nn = warm
                run_one(nn, idxs)
        wall = time.perf_counter() - t0
        # ops left without an outcome (every namenode died mid-run) fail
        # the way a client with no namenodes to fail over to would
        for i, oc in enumerate(outcomes):
            if oc is None:
                outcomes[i] = OpOutcome(None, "StoreError")
        return self._finalize_stats(wops, outcomes, cost0, served0, wall,
                                    n_batches[0])

    def _finalize_stats(self, wops: Sequence[WorkloadOp],
                        outcomes: Sequence[Optional[OpOutcome]],
                        cost0: Dict[int, OpCost], served0: Dict[int, int],
                        wall: float, n_batches: int) -> PipelineStats:
        """Conserved-accounting roll-up shared by the reactive and planned
        pipelines: per-namenode cost deltas, total cost over successful
        outcomes, and the batched read/write op split."""
        # namenodes absent from the snapshots joined mid-run (elastic
        # scale-out): their whole lifetime cost belongs to this run
        per_nn_cost = {nn.nn_id: nn.agg_cost.diff(cost0.get(nn.nn_id,
                                                            OpCost()))
                       for nn in self.cluster.namenodes}
        per_nn_ops = {nn.nn_id: nn.ops_served - served0.get(nn.nn_id, 0)
                      for nn in self.cluster.namenodes}
        total = OpCost()
        ok = failed = 0
        for oc in outcomes:
            if oc.ok:
                ok += 1
                total.merge(oc.result.cost)  # type: ignore[union-attr]
            else:
                failed += 1
        b_reads = b_writes = 0
        for wop, oc in zip(wops, outcomes):
            # only SERVED ops count toward the read/write batched split,
            # matching the per-namenode batched_ops/batched_write_ops
            # counters (a grouped op that errored is not "served by" the
            # grouped transaction)
            if oc is not None and oc.batched and oc.ok:
                s = REGISTRY.get(wop.op)
                if s is not None and s.read_only:
                    b_reads += 1
                else:
                    b_writes += 1
        return PipelineStats(outcomes=list(outcomes),  # type: ignore
                             per_nn_cost=per_nn_cost, per_nn_ops=per_nn_ops,
                             total_cost=total, ok=ok, failed=failed,
                             wall_s=wall, batch_size=self.batch_size,
                             n_batches=n_batches,
                             batched_read_ops=b_reads,
                             batched_write_ops=b_writes)


def namespace_snapshot(store: MetadataStore) -> Dict[str, Tuple]:
    """Logical namespace view: full path -> (is_dir, size, perm, owner,
    repl, n_blocks). Physical identifiers (inode/block ids, per-namenode
    mtime clocks) are deliberately absent, so two runs that dispatched ops
    to different namenodes — and therefore drew from different id-allocator
    blocks — can still be compared for namespace equivalence."""
    rows: Dict[int, Dict[str, Any]] = {}
    for part in store.table("inode").parts:
        for row in part.values():
            rows[row["id"]] = row
    blocks_per_inode: Dict[int, int] = {}
    for part in store.table("block").parts:
        for row in part.values():
            blocks_per_inode[row["inode_id"]] = \
                blocks_per_inode.get(row["inode_id"], 0) + 1

    paths: Dict[int, str] = {ROOT_ID: ""}

    def path_of(iid: int) -> Optional[str]:
        # iterative ancestor walk: deep namespaces (depth >> 1000) would
        # blow Python's recursion limit with the naive recursive form
        chain: List[Tuple[int, Dict[str, Any]]] = []
        seen: Set[int] = set()
        cur = iid
        while cur not in paths:
            row = rows.get(cur)
            if row is None or cur in seen:    # orphan or corrupt cycle
                return None
            seen.add(cur)
            chain.append((cur, row))
            cur = row["parent_id"]
        p = paths[cur]
        for cid, row in reversed(chain):
            p = p + "/" + row["name"]
            paths[cid] = p
        return p

    snap: Dict[str, Tuple] = {}
    for iid, row in rows.items():
        if iid == ROOT_ID:
            continue
        p = path_of(iid)
        if p is None:
            continue
        snap[p] = (row["is_dir"], row["size"], row["perm"], row["owner"],
                   row["repl"], blocks_per_inode.get(iid, 0))
    return snap


def materialize_namespace(nn: Namenode, ns) -> int:
    """Ensure a :class:`~repro_torch.core.workload.SyntheticNamespace`'s dirs and
    files exist in the live store so trace replay targets resolve.
    Idempotent; returns the number of namespace paths ensured present."""
    for d in ns.dirs:
        try:
            nn.ops.mkdirs(d)
        except FSError:
            pass
    for f in ns.files:
        try:
            nn.ops.create(f)
        except FSError:
            pass
    return len(ns.dirs) + len(ns.files)


def materialize_big_dir(nn: Namenode, path: str, n_children: int, *,
                        file_prefix: str = "f") -> int:
    """Bulk-load a flat directory of ``n_children`` file inodes (the
    million-entry-directory scenario's fixture).

    Test/bench scaffolding, not a modeled op: the directory itself is
    created through the normal op path, but children are direct table
    puts — no transactions, no mtime ticks — so loading the same plan
    into two stores leaves them byte-identical.  Ids still come from the
    namenode's allocator, keeping ``id_seq`` consistent for follow-on
    ops.  Returns the directory's inode id."""
    from .tables import make_inode
    nn.ops.mkdirs(path)
    t = nn.store.table("inode")
    parent = ROOT_ID
    for name in split_path(path):
        parent = t.get((parent, name))["id"]
    for i in range(n_children):
        iid = nn.ops.inode_ids.next_id()
        t.put(make_inode(iid, parent, f"{file_prefix}{i:06d}", False))
    return parent
