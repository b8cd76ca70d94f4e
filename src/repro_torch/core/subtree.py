"""Subtree operations protocol (paper §6).

Operations on directories of unknown (possibly millions) of inodes — delete,
move/rename, chmod, chown, set-quota — cannot lock millions of rows in one
OLTP transaction. HopsFS isolates the subtree with an **application-level
distributed lock** and then executes the operation as many small parallel
transactions:

  Phase 1 — take an exclusive row lock on the subtree root, verify *no other
            active subtree op* exists anywhere below (query of the
            ongoing-subtree-ops table), then set + persist the ``subtree_lock``
            flag (stamped with the owning namenode id). In-flight inode ops
            that encounter the flag voluntarily abort (§6.3).
  Phase 2 — quiesce: wave-by-wave down the tree, take-and-release write locks
            on every descendant in the same total order inode ops use, via
            parallel partition-pruned index scans (children of one directory
            live on one shard, §4.2), reading only projections (inode ids)
            for efficiency.  The default **incremental** mode streams the
            waves — at most :attr:`SubtreeOps.wave_cap` directories are
            expanded per scan round and file rows are flushed to phase 3 as
            soon as a chunk fills, so memory stays bounded by one wave + one
            chunk instead of the whole subtree.  The legacy mode
            (``incremental=False``) still materializes the full
            :class:`TreeNode` tree for callers that want it.
  Phase 3 — execute: delete runs grouped chunk transactions **leaves first**
            so a namenode crash never orphans inodes (§6.2): files are
            deleted during the descent (they are always leaves), directories
            deepest level first afterwards, and the root row — the one
            carrying the subtree flag — commits last, alone.  Chunks whose
            anchor partitions differ commit in parallel ("many small
            parallel transactions"); a :attr:`SubtreeOps.pace` hook runs
            between chunk commits so adjacent inode ops interleave with a
            long-running subtree op.  Rename/chmod/chown/quota mutate only
            the subtree root in a single small transaction.

On the columnar store each BFS wave is additionally resolved by ONE fused
``treeagg`` launch over the inode table's hot columns on the store's
device.  The launch is ADVISORY here — the transactional scans stay
authoritative (and charge identical :class:`OpCost` on both backends) — but
it exercises and cross-checks the exact kernel the ``du`` aggregation
trusts.

Failure handling (§6.2): the flag holds the owner namenode's id; any other
namenode finding a flag owned by a dead namenode reclaims it. A delete that
died mid-way leaves a consistent (smaller) tree that the client retries on
another namenode.  Chunk boundaries are the crash points: every chunk is
all-or-nothing, and the leaves-first order means whatever committed before
the crash is a forest of complete deletions.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .fs import (FSError, FileAlreadyExists, FileNotFound, HopsFSOps,
                 OpResult, SubtreeLockedError, split_path)
from .store import EXCLUSIVE, OpCost
from .transactions import Transaction

#: phase-2/3 node record: (inode_id, parent_id, name, is_dir) — a plain
#: tuple, NOT a TreeNode, so the streaming path holds four machine words
#: per resident inode and nothing else
NodeRow = Tuple[int, int, str, bool]


@dataclass
class TreeNode:
    inode_id: int
    parent_id: int
    name: str
    is_dir: bool
    children: List["TreeNode"] = field(default_factory=list)

    def count(self) -> int:
        # iterative: million-entry trees must not hit the recursion limit
        n = 0
        stack = [self]
        while stack:
            node = stack.pop()
            n += 1
            stack.extend(node.children)
        return n


def _post_order(tree: TreeNode) -> List[TreeNode]:
    """Iterative post-order (children before parents), identical ordering
    to the old recursive ``post()`` but safe for depth >> the Python
    recursion limit."""
    order: List[TreeNode] = []
    stack: List[Tuple[TreeNode, bool]] = [(tree, False)]
    while stack:
        node, expanded = stack.pop()
        if expanded:
            order.append(node)
            continue
        stack.append((node, True))
        for c in reversed(node.children):
            stack.append((c, False))
    return order


class _BoundedWaitPool:
    """Persistent worker pool where every wait is bounded.

    Functionally ``ThreadPoolExecutor.map``, with two robustness twists:
    workers poll the task queue with short timeouts (a timed-out waiter
    re-checks shared state, so a single missed wakeup costs milliseconds
    instead of hanging the op), and the submitting thread work-steals
    from the same queue while it waits, so a ``map`` completes even if
    every worker is wedged or has idled out. Workers exit after a couple
    of idle seconds and are respawned on the next ``map``, keeping the
    steady-state thread count proportional to recent subtree activity.
    """

    _POLL = 0.02
    _IDLE_EXIT = 2.0

    def __init__(self, n_workers: int):
        self.n = max(1, n_workers)
        self._tasks: "queue.Queue[Callable[[], None]]" = queue.Queue()
        self._threads: List[threading.Thread] = []

    def _worker(self) -> None:
        idle = 0.0
        while idle < self._IDLE_EXIT:
            try:
                task = self._tasks.get(timeout=self._POLL)
            except queue.Empty:
                idle += self._POLL
                continue
            idle = 0.0
            task()

    def _ensure_workers(self, wanted: int) -> None:
        self._threads = [t for t in self._threads if t.is_alive()]
        while len(self._threads) < min(self.n, wanted):
            t = threading.Thread(target=self._worker, daemon=True)
            t.start()
            self._threads.append(t)

    def map(self, fn: Callable[[Any], Any], items: Sequence[Any]
            ) -> List[Any]:
        items = list(items)
        if len(items) <= 1 or self.n <= 1:
            return [fn(x) for x in items]
        # workers take items[1:]; the submitter always runs one itself
        self._ensure_workers(len(items) - 1)
        results: List[Any] = [None] * len(items)
        errors: List[BaseException] = []
        pending = [len(items)]
        lock = threading.Lock()

        def run_one(i: int, x: Any) -> Callable[[], None]:
            def task() -> None:
                try:
                    results[i] = fn(x)
                except BaseException as exc:   # noqa: BLE001 — re-raised
                    errors.append(exc)
                finally:
                    with lock:
                        pending[0] -= 1
            return task

        for i, x in enumerate(items[1:], start=1):
            self._tasks.put(run_one(i, x))
        run_one(0, items[0])()
        while True:
            with lock:
                if pending[0] == 0:
                    break
            try:
                task = self._tasks.get_nowait()
            except queue.Empty:
                time.sleep(self._POLL / 4)
            else:
                task()
        if errors:
            raise errors[0]
        return results


def _empty_stats() -> Dict[str, Any]:
    return {"waves": 0, "scanned": 0, "peak_frontier": 0, "chunks": 0,
            "chunk_costs": []}


class SubtreeOps:
    """Subtree operations for one namenode, layered over HopsFSOps."""

    def __init__(self, ops: HopsFSOps, *, batch_size: int = 1000,
                 parallelism: int = 8,
                 crash_after_batches: Optional[int] = None,
                 incremental: bool = True, wave_cap: int = 4096):
        self.ops = ops
        self.store = ops.store
        self.batch_size = batch_size
        self.parallelism = parallelism
        # fault-injection hook: simulate the executing namenode dying after
        # N phase-3 batches (used by tests to verify §6.2 consistency)
        self.crash_after_batches = crash_after_batches
        #: generalized chaos hook (chaos.FaultInjector.install); fires the
        #: "subtree_chunk" site between phase-3 chunk commits
        self.chaos: Optional[Any] = None
        #: streaming phase 2 (bounded waves, files flushed during descent);
        #: False = legacy full-tree materialization
        self.incremental = incremental
        #: max directories expanded per phase-2 scan round
        self.wave_cap = wave_cap
        #: called between phase-3 chunk commits — the pacing point where
        #: adjacent (non-subtree) inode ops interleave with a long delete.
        #: Setting it forces chunks sequential (the hook IS the schedule).
        self.pace: Optional[Callable[[], None]] = None
        #: telemetry for the most recent subtree op (reset per op)
        self.last_stats: Dict[str, Any] = _empty_stats()
        #: lifetime ``scan_index("id", ...)`` hops spent on ancestor walks
        #: (the phase-1 overlap check) — what the scaling suite bounds
        self.ancestor_scans = 0
        # treeagg kernel telemetry (advisory phase-2 launches); a mismatch
        # is a wave whose launch and scans disagreed on the child count
        self.treeagg_launches = 0
        self.treeagg_mismatches = 0
        # one persistent pool per namenode, shared by wave scans and
        # parallel chunk commits (never nested), sized lazily at first use
        self._executor: Optional[_BoundedWaitPool] = None

    def _reset_stats(self) -> None:
        self.last_stats = _empty_stats()

    # ------------------------------------------------------------------
    # Phase 1: subtree lock
    # ------------------------------------------------------------------
    def _phase1_lock(self, path: str) -> Tuple[Dict[str, Any], OpCost]:
        comps = split_path(path)
        with self.ops._begin(self.ops._hint_for(comps, parent=False)) as txn:
            rp = self.ops._resolve(txn, comps, last_lock=EXCLUSIVE,
                                   path=path)
            root = rp.target
            if root is None:
                raise FileNotFound(path)
            if not root["is_dir"]:
                raise FSError(f"not a directory: {path}")
            # no active subtree operation anywhere below (or above) us:
            # the ongoing-subtree-ops table is small (subtree ops are a tiny
            # fraction of the workload) but the check is an all-shard IS.
            active = txn.full_scan("ongoing_subtree_ops", lambda r: True)
            overlaps = None
            for a in active:
                if self.ops._is_nn_alive(a["namenode_id"]):
                    if overlaps is None:
                        overlaps = self._overlap_check(root["id"])
                    if overlaps(a["inode_id"]):
                        raise SubtreeLockedError(
                            f"active subtree op on inode {a['inode_id']}")
                else:
                    txn.delete("ongoing_subtree_ops", (a["inode_id"],))
            locked = dict(root)
            locked["subtree_lock"] = self.ops.nn_id
            txn.write("inode", locked)
            txn.write("ongoing_subtree_ops",
                      {"inode_id": root["id"],
                       "namenode_id": self.ops.nn_id, "op": "subtree"})
            cost = txn.commit()
        return locked, cost

    def _overlap_check(self, root_id: int) -> Callable[[int], bool]:
        """Factory for the phase-1 conflict test: two subtree ops conflict
        iff one root lies on the other's ancestor chain.

        The naive test walked the parent chain twice per active row —
        O(active x depth) ``scan_index`` hops, quadratic on deep trees.
        This form walks the target's own chain ONCE into an ancestor set,
        then memoizes each active root's walk (every visited node learns
        whether its chain reaches ``root_id``), so k active rows on a
        depth-d tree cost O(d + k + distinct hops) total."""
        t = self.store.table("inode")
        anc = {root_id}
        cur = root_id
        hops = 0
        while cur != 0 and hops < 10_000:
            rows = t.scan_index("id", cur)
            self.ancestor_scans += 1
            if not rows:
                break
            cur = rows[0]["parent_id"]
            anc.add(cur)
            hops += 1
        memo: Dict[int, bool] = {}

        def overlaps(a_id: int) -> bool:
            # a_id above (or at) the target root => the target is inside a
            if a_id in anc:
                return True
            trail: List[int] = []
            cur = a_id
            verdict = False
            hops = 0
            while hops < 10_000:
                if cur == root_id:
                    verdict = True
                    break
                if cur in memo:
                    verdict = memo[cur]
                    break
                if cur in anc or cur == 0:
                    # joined the target's chain ABOVE the root (or hit the
                    # fs root): disjoint subtrees
                    verdict = False
                    break
                trail.append(cur)
                rows = t.scan_index("id", cur)
                self.ancestor_scans += 1
                if not rows:
                    verdict = False
                    break
                cur = rows[0]["parent_id"]
                hops += 1
            for nid in trail:
                memo[nid] = verdict
            return verdict

        return overlaps

    def _is_descendant_or_self(self, node_id: int, ancestor_id: int) -> bool:
        t = self.store.table("inode")
        cur = node_id
        seen = 0
        while cur not in (0,) and seen < 10_000:
            if cur == ancestor_id:
                return True
            rows = t.scan_index("id", cur)
            self.ancestor_scans += 1
            if not rows:
                return False
            cur = rows[0]["parent_id"]
            seen += 1
        return False

    def _unlock(self, root: Dict[str, Any], cost: OpCost) -> None:
        with Transaction(self.store,
                         partition_hint=("inode", root["parent_id"]),
                         distribution_aware=self.ops.dat) as txn:
            cur = txn.read("inode", (root["parent_id"], root["name"]),
                           EXCLUSIVE)
            if cur is not None and cur.get("subtree_lock") == self.ops.nn_id:
                cur = dict(cur)
                cur["subtree_lock"] = None
                txn.write("inode", cur)
            txn.delete("ongoing_subtree_ops", (root["id"],))
            cost.merge(txn.commit())

    # ------------------------------------------------------------------
    # Phase 2: quiesce (streaming waves / legacy full tree)
    # ------------------------------------------------------------------
    def _fused_wave(self, dir_ids: Sequence[int]) -> Optional[Any]:
        """ADVISORY columnar fast path: resolve the whole wave in one
        ``treeagg`` launch over the inode hot columns.  Charges zero
        OpCost — the transactional scans remain authoritative and
        cost-identical across backends — but exercises and cross-checks
        the exact kernel the ``du`` aggregation trusts.  None on the dict
        backend / below the slot-count gate; a kernel error is raised."""
        from .columnar import expand_wave
        exp = expand_wave(self.store, dir_ids)
        if exp is not None:
            self.treeagg_launches += 1
        return exp

    def _pool(self) -> _BoundedWaitPool:
        """The namenode's long-lived scan/commit pool. Spinning a fresh
        pool per wave churns thread create/join on every subtree op; one
        persistent pool amortizes it across the namenode's life. Wave
        scans and chunk commits never nest, so sharing is safe."""
        if self._executor is None:
            self._executor = _BoundedWaitPool(self.parallelism)
        return self._executor

    def _wave_scan(self, dir_ids: Sequence[int], cost: OpCost
                   ) -> List[List[Dict[str, Any]]]:
        """Take-and-release EXCLUSIVE child scans for one wave of
        directories — one partition-pruned scan per directory (all
        children co-located, §4.2), a thread pool across directories.
        Returns the child-row lists aligned with ``dir_ids``."""
        exp = self._fused_wave(dir_ids)

        def scan_dir(did: int) -> List[Dict[str, Any]]:
            with Transaction(self.store, partition_hint=("inode", did),
                             distribution_aware=self.ops.dat) as txn:
                # take-and-release write locks on the children wave
                # (projection: ids only — §6.1 "reduce the overhead")
                if self.ops.adp:
                    kids = txn.ppis("inode", "parent_id", did, EXCLUSIVE,
                                    projection=("id", "parent_id", "name",
                                                "is_dir"))
                else:
                    kids = txn.index_scan("inode", "parent_id", did,
                                          EXCLUSIVE)
                cost.merge(txn.commit())
            return kids

        if len(dir_ids) > 1 and self.parallelism > 1:
            kid_lists = list(self._pool().map(scan_dir, dir_ids))
        else:
            kid_lists = [scan_dir(d) for d in dir_ids]
        if exp is not None \
                and exp.n_children != sum(len(k) for k in kid_lists):
            # concurrent mutation between launch and scans: scans win
            self.treeagg_mismatches += 1
        return kid_lists

    def _phase2_build_tree(self, root: Dict[str, Any], cost: OpCost
                           ) -> TreeNode:
        """Legacy quiesce: BFS down the tree materializing the whole
        :class:`TreeNode` tree in memory (O(subtree) resident)."""
        tree = TreeNode(root["id"], root["parent_id"], root["name"], True)
        frontier = [tree]
        st = self.last_stats
        while frontier:
            st["waves"] += 1
            kid_lists = self._wave_scan([n.inode_id for n in frontier], cost)
            next_frontier: List[TreeNode] = []
            for node, kids in zip(frontier, kid_lists):
                st["scanned"] += len(kids)
                node.children = [TreeNode(k["id"], k["parent_id"], k["name"],
                                          k["is_dir"]) for k in kids]
                next_frontier.extend(c for c in node.children if c.is_dir)
            frontier = next_frontier
        return tree

    def _phase2_quiesce(self, root: Dict[str, Any], cost: OpCost) -> int:
        """Streaming wave quiesce for root-only phase-3 ops: identical
        take-and-release lock waves to the tree build, but nothing is
        retained beyond the next frontier's directory ids (and each scan
        round expands at most ``wave_cap`` directories)."""
        st = self.last_stats
        wave = [root["id"]]
        total = 0
        while wave:
            st["waves"] += 1
            nxt: List[int] = []
            for s in range(0, len(wave), self.wave_cap):
                kid_lists = self._wave_scan(wave[s:s + self.wave_cap], cost)
                for kids in kid_lists:
                    st["scanned"] += len(kids)
                    total += len(kids)
                    nxt.extend(k["id"] for k in kids if k["is_dir"])
                resident = len(nxt) + (len(wave) - s)
                if resident > st["peak_frontier"]:
                    st["peak_frontier"] = resident
            wave = nxt
        return total

    def _phase2(self, root: Dict[str, Any], cost: OpCost) -> None:
        if self.incremental:
            self._phase2_quiesce(root, cost)
        else:
            self._phase2_build_tree(root, cost)

    # ------------------------------------------------------------------
    # Phase 3: grouped chunk commits
    # ------------------------------------------------------------------
    def _commit_chunk(self, chunk: Sequence[NodeRow]) -> OpCost:
        """One phase-3 grouped transaction: every inode in the chunk
        shares the txn (the ``Namenode._write_group_txn`` discipline),
        anchored on the first node's parent partition."""
        with Transaction(self.store,
                         partition_hint=("inode", chunk[0][1]),
                         distribution_aware=self.ops.dat) as txn:
            for iid, pid, name, is_dir in chunk:
                if not is_dir:
                    related = self.ops._file_scan(
                        txn, ("block", "replica", "ruc", "inv"),
                        iid, EXCLUSIVE)
                    for tname, rws in related.items():
                        schema = self.store.table(tname).schema
                        for r in rws:
                            txn.delete(tname,
                                       tuple(r[c] for c in schema.pk))
                txn.delete("inode", (pid, name))
                if self.ops.cache:
                    self.ops.cache.invalidate(pid, name)
            return txn.commit()

    def _exec_chunks(self, nodes: Sequence[NodeRow], cost: OpCost,
                     progress: Dict[str, int], *,
                     allow_parallel: bool = False) -> bool:
        """Flush ``nodes`` in ``batch_size`` chunks.  Chunks with distinct
        anchor partitions commit concurrently when ``allow_parallel`` (the
        caller guarantees the nodes are deletion-order-independent, e.g.
        all leaves); pacing, chaos and simulated crashes force the
        sequential path so their per-chunk semantics stay deterministic.
        Per-chunk costs are attributed into ``last_stats["chunk_costs"]``
        via OpCost diffs.  Returns True on a simulated crash."""
        if not nodes:
            return False
        bs = self.batch_size
        chunks = [nodes[i:i + bs] for i in range(0, len(nodes), bs)]
        st = self.last_stats
        seq = (not allow_parallel or self.pace is not None
               or self.chaos is not None
               or self.crash_after_batches is not None
               or self.parallelism <= 1)
        t = self.store.table("inode")
        i = 0
        while i < len(chunks):
            if seq:
                group = [chunks[i]]
                i += 1
            else:
                # partition-disjoint run: consecutive chunks whose anchor
                # partitions differ commit concurrently (§6 "many small
                # parallel transactions"); a repeat partition ends the run
                group = [chunks[i]]
                parts = {t.partition_of(chunks[i][0][1])}
                i += 1
                while i < len(chunks) and len(group) < self.parallelism:
                    p = t.partition_of(chunks[i][0][1])
                    if p in parts:
                        break
                    parts.add(p)
                    group.append(chunks[i])
                    i += 1
            if len(group) == 1:
                chunk = group[0]
                if self.chaos is not None:
                    # chunk-commit boundary: a crash here leaves the
                    # subtree flag set and a consistent smaller tree
                    self.chaos.fire("subtree_chunk", self.ops.nn_id)
                if self.crash_after_batches is not None \
                        and progress["batches"] >= self.crash_after_batches:
                    # simulated namenode crash: subtree lock flag remains,
                    # already-deleted leaves are gone, rest still attached.
                    return True
                before = cost.copy()
                cost.merge(self._commit_chunk(chunk))
                st["chunk_costs"].append(cost.diff(before).as_dict())
                progress["batches"] += 1
                progress["deleted"] += len(chunk)
                if self.pace is not None:
                    self.pace()
            else:
                ccosts = list(self._pool().map(self._commit_chunk, group))
                for chunk, cc in zip(group, ccosts):
                    cost.merge(cc)
                    st["chunk_costs"].append(cc.as_dict())
                    progress["batches"] += 1
                    progress["deleted"] += len(chunk)
        return False

    # ------------------------------------------------------------------
    # Phase 3 executors
    # ------------------------------------------------------------------
    def delete_subtree(self, path: str) -> OpResult:
        """Recursive delete, grouped chunk commits leaves-first so a crash
        leaves no orphans (§6.2). Returns #inodes deleted."""
        self._reset_stats()
        root, cost = self._phase1_lock(path)
        progress = {"deleted": 0, "batches": 0}
        try:
            if self.incremental:
                crashed = self._delete_streamed(root, cost, progress)
            else:
                crashed = self._delete_legacy(root, cost, progress)
            self.last_stats["chunks"] = progress["batches"]
            if crashed:
                return OpResult({"deleted": progress["deleted"],
                                 "crashed": True}, cost)
            # root row is gone; update parent mtime + drop subtree-ops row
            with Transaction(self.store,
                             partition_hint=("inode", root["parent_id"]),
                             distribution_aware=self.ops.dat) as txn:
                txn.delete("ongoing_subtree_ops", (root["id"],))
                prow = self.store.table("inode").scan_index(
                    "id", root["parent_id"])
                if prow:
                    p = dict(prow[0])
                    p["mtime"] = next(self.ops.clock)
                    txn.write("inode", p)
                cost.merge(txn.commit())
            return OpResult({"deleted": progress["deleted"],
                             "crashed": False}, cost)
        except Exception as e:
            if getattr(e, "chaos_crash", False):
                raise     # a crashed namenode cannot run cleanup: the
                          # subtree flag stays for a survivor to reclaim
            self._unlock(root, cost)
            raise

    def _delete_streamed(self, root: Dict[str, Any], cost: OpCost,
                         progress: Dict[str, int]) -> bool:
        """Incremental delete: files flush to chunk commits DURING the
        descent (files are always leaves, so every prefix of commits is a
        consistent smaller tree), directory rows are retained per level
        and deleted deepest level first, the root row last and alone."""
        st = self.last_stats
        rootnode: NodeRow = (root["id"], root["parent_id"], root["name"],
                             True)
        pending: List[NodeRow] = []
        dir_levels: List[List[NodeRow]] = []
        wave: List[NodeRow] = [rootnode]
        retained = 1
        while wave:
            st["waves"] += 1
            next_wave: List[NodeRow] = []
            for s in range(0, len(wave), self.wave_cap):
                sl = wave[s:s + self.wave_cap]
                kid_lists = self._wave_scan([n[0] for n in sl], cost)
                for kids in kid_lists:
                    st["scanned"] += len(kids)
                    resident = (retained + len(next_wave) + len(pending)
                                + len(kids))
                    if resident > st["peak_frontier"]:
                        st["peak_frontier"] = resident
                    for k in kids:
                        node: NodeRow = (k["id"], k["parent_id"], k["name"],
                                         k["is_dir"])
                        if node[3]:
                            next_wave.append(node)
                        else:
                            pending.append(node)
                    while len(pending) >= self.batch_size:
                        flush = pending[:self.batch_size]
                        pending = pending[self.batch_size:]
                        if self._exec_chunks(flush, cost, progress,
                                             allow_parallel=True):
                            return True
            if next_wave:
                dir_levels.append(next_wave)
                retained += len(next_wave)
            wave = next_wave
        if self._exec_chunks(pending, cost, progress, allow_parallel=True):
            return True
        for level in reversed(dir_levels):   # deepest dirs first (§6.2)
            if self._exec_chunks(level, cost, progress, allow_parallel=True):
                return True
        # the root row goes LAST, alone: its delete clears the subtree
        # flag, so nothing below it may still exist when it commits
        return self._exec_chunks([rootnode], cost, progress)

    def _delete_legacy(self, root: Dict[str, Any], cost: OpCost,
                       progress: Dict[str, int]) -> bool:
        """Legacy delete: full tree materialization + one sequential
        post-order chunk pass (the pre-incremental behaviour, kept as the
        differential oracle for the streamed path)."""
        tree = self._phase2_build_tree(root, cost)
        order = _post_order(tree)
        st = self.last_stats
        st["peak_frontier"] = max(st["peak_frontier"], len(order))
        nodes = [(n.inode_id, n.parent_id, n.name, n.is_dir) for n in order]
        return self._exec_chunks(nodes, cost, progress)

    def _root_only_op(self, path: str, mutate) -> OpResult:
        """chmod/chown on a directory: phases 1-2 isolate and quiesce,
        phase 3 is a single small transaction updating only the subtree
        root (§6.2: inner inodes untouched => trivially
        failure-consistent)."""
        self._reset_stats()
        root, cost = self._phase1_lock(path)
        try:
            self._phase2(root, cost)
            with Transaction(self.store,
                             partition_hint=("inode", root["parent_id"]),
                             distribution_aware=self.ops.dat) as txn:
                cur = txn.read("inode", (root["parent_id"], root["name"]),
                               EXCLUSIVE)
                if cur is None:
                    raise FileNotFound(path)
                cur = dict(cur)
                mutate(cur)
                cur["mtime"] = next(self.ops.clock)
                cur["subtree_lock"] = None
                txn.write("inode", cur)
                txn.delete("ongoing_subtree_ops", (root["id"],))
                cost.merge(txn.commit())
            return OpResult(None, cost)
        except Exception:
            self._unlock(root, cost)
            raise

    def chmod_subtree(self, path: str, perm: int) -> OpResult:
        return self._root_only_op(path, lambda n: n.update(perm=perm))

    def chown_subtree(self, path: str, owner: str) -> OpResult:
        return self._root_only_op(path, lambda n: n.update(owner=owner))

    def set_quota_subtree(self, path: str, *, ns_quota: int = -1,
                          ss_quota: int = -1) -> OpResult:
        self._reset_stats()
        root, cost = self._phase1_lock(path)
        try:
            self._phase2(root, cost)
            with Transaction(self.store,
                             partition_hint=("inode", root["id"]),
                             distribution_aware=self.ops.dat) as txn:
                q = self.store.table("quota").get((root["id"],))
                qrow = dict(q) if q else {"inode_id": root["id"],
                                          "ns_used": 0, "ss_used": 0}
                qrow["ns_quota"], qrow["ss_quota"] = ns_quota, ss_quota
                txn.write("quota", qrow)
                cost.merge(txn.commit())
            self._unlock(root, cost)
            return OpResult(None, cost)
        except Exception:
            self._unlock(root, cost)
            raise

    def rename_subtree(self, src: str, dst: str) -> OpResult:
        """Directory move: phases 1-2, then a single phase-3 transaction
        that re-parents ONLY the subtree root (children keep their
        parent-id; their absolute paths change implicitly). The root's
        composite PK changes => delete+insert of one row."""
        self._reset_stats()
        root, cost = self._phase1_lock(src)
        try:
            self._phase2(root, cost)
            dc = split_path(dst)
            with Transaction(self.store, partition_hint=(
                    "inode", self.ops._hint_for(dc, parent=True)),
                    distribution_aware=self.ops.dat) as txn:
                drp = self.ops._resolve(txn, dc, last_lock=EXCLUSIVE,
                                        lock_parent=True, path=dst)
                if drp.target is not None:
                    raise FileAlreadyExists(dst)
                # a directory must never move under its own subtree — the
                # re-parent would cut the tree into an unreachable parent
                # cycle that phase-2 scans of any ancestor then chase
                # forever
                if self._is_descendant_or_self(drp.parent["id"],
                                               root["id"]):
                    raise FSError(
                        f"cannot rename {src} under its own subtree "
                        f"({dst})")
                cur = txn.read("inode", (root["parent_id"], root["name"]),
                               EXCLUSIVE)
                if cur is None:
                    raise FileNotFound(src)
                txn.delete("inode", (root["parent_id"], root["name"]))
                moved = dict(cur)
                moved["parent_id"], moved["name"] = drp.parent["id"], dc[-1]
                moved["mtime"] = next(self.ops.clock)
                moved["subtree_lock"] = None
                txn.write("inode", moved)
                dp = dict(drp.parent)
                dp["mtime"] = next(self.ops.clock)
                txn.write("inode", dp)
                txn.delete("ongoing_subtree_ops", (root["id"],))
                if self.ops.cache:
                    self.ops.cache.invalidate(root["parent_id"],
                                              root["name"])
                    self.ops.cache.put(drp.parent["id"], dc[-1], root["id"])
                cost.merge(txn.commit())
            return OpResult(None, cost)
        except Exception:
            self._unlock(root, cost)
            raise
