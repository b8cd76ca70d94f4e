"""Client-side columnar batch planner + the closed-loop planned pipeline.

The paper's throughput headline (Fig 7) comes from *distribution-aware,
batched* transactions (§2.2, §5.1). The reactive pipeline only discovers
batching opportunities after the fact: fixed-size FIFO batches are dealt to
namenodes and ``execute_batch`` groups whatever same-type, same-partition
runs happen to be adjacent. This module moves that discovery to the CLIENT
side of the metadata path (the λFS lesson — see PAPERS.md):

  1. **lower**   — a trace window is lowered to struct-of-arrays form
     (:func:`~repro_torch.core.workload.lower_trace`): per-op type ids plus the
     hint-cache chain resolution broken out per path component;
  2. **hash**    — every op's component chain and hinted target are hashed
     in ONE fused ``phash_chain`` kernel launch
     (:func:`~repro_torch.kernels.phash.ops.phash_chains`), giving each op its
     coordinator partition and a chain signature;
  3. **pin**     — mutations whose paths collide (same path, or one a
     path-prefix of another, subtree ops included), destructive ops, and
     ops that did not resolve client-side are *pinned*: they keep their
     submission order, because reordering them could change the final
     namespace or spuriously fail an op. Read-only resolved ops are never
     pinned (they cannot change final state);
  4. **deal**    — free ops are sorted by (partition, type) and chunked
     into partition-aligned, type-sorted batches routed to the namenode
     slot owning that partition, each op carrying its client-side
     resolution as a :class:`~repro_torch.core.namenode.PlanHint`. The namenode
     executors therefore see maximal groupable runs whose shared
     distribution-aware transactions land on their coordinator's node
     group (raising the local round-trip share, §7.7).

The pipeline is **closed-loop** (see ``docs/HINTS.md``): the client's hint
view is its OWN :class:`~repro_torch.core.hint_cache.InodeHintCache`, warmed
from the ``(parent_id, name) -> inode_id`` resolutions namenode responses
piggyback (``OpResult.hints``) and invalidated on destructive ops; the
merged namenode caches (:class:`MultiCacheResolver`) are only the
cold-start FALLBACK. Each window is planned, executed, and absorbed before
the next window is planned, and a :class:`WindowController` feedback loop
resizes the planning window from the observed conflict-pin rate and
round-trips-per-op — the window is a control variable, not a constant.

Planned execution guarantees *final-state* equivalence with sequential
execution (asserted by tests/test_batched_pipeline.py and
tests/test_closed_loop_pipeline.py); per-op result streams may differ for
reads reordered across mutations, exactly as with any concurrent client
population. Deterministic mode executes the plan in order; concurrent mode
runs one worker per alive namenode WITHIN each window (windows are
barriers, so window-scoped conflict analysis stays sound), with
lease-ordered same-key runs kept whole in one batch so same-file block
writes can never interleave across workers while distinct-file block
writes group concurrently.
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .columnar import lower_trace_fused, validate_window_pks
from .hint_cache import InodeHintCache, absorb_response
from .namenode import (PHASH_MIN_BATCH, NamenodeCluster, OpOutcome,
                       PipelineStats, PlanHint, RequestPipeline)
from .ops_registry import REGISTRY, WorkloadOp
from .store import StoreError, _hash_key
from .tables import split_path
from .workload import ColumnarTrace

__all__ = ["BatchPlanner", "HintResolver", "MultiCacheResolver",
           "PlannedBatch", "PlannedRequestPipeline", "PlanReport",
           "WindowController"]


class MultiCacheResolver:
    """The merged view of every alive namenode's inode hint cache, probed
    side-effect-free (no LRU churn, no skewed hit/miss counters on the
    namenodes). Since the closed-loop pipeline this is the cold-start
    FALLBACK behind the client's own response-warmed cache
    (:class:`HintResolver`) — not the primary resolution path."""

    def __init__(self, caches: Sequence[Any]):
        self.caches = [c for c in caches if c is not None]

    @classmethod
    def of_cluster(cls, cluster: NamenodeCluster) -> "MultiCacheResolver":
        return cls([nn.ops.cache for nn in cluster.alive_namenodes()])

    def peek(self, parent_id: int, name: str) -> Optional[int]:
        for c in self.caches:
            v = c.peek(parent_id, name)
            if v is not None:
                return v
        return None


class HintResolver:
    """The closed-loop client hint view: the client's OWN cache (warmed by
    response piggybacking, ``OpResult.hints``) first, a fallback resolver
    (the merged namenode caches) only on a miss. Probe-level telemetry:
    ``hits`` (client cache), ``fallback_hits`` (namenode caches vouched),
    ``misses`` (nobody knew — the op stays unresolved or resolves
    server-side)."""

    def __init__(self, cache: InodeHintCache, fallback: Any = None):
        self.cache = cache
        self.fallback = fallback
        self.hits = 0
        self.fallback_hits = 0
        self.misses = 0

    def peek(self, parent_id: int, name: str) -> Optional[int]:
        v = self.cache.peek(parent_id, name)
        if v is not None:
            self.hits += 1
            return v
        if self.fallback is not None:
            v = self.fallback.peek(parent_id, name)
            if v is not None:
                self.fallback_hits += 1
                return v
        self.misses += 1
        return None


class WindowController:
    """Feedback controller for the planning-window size (AIMD-flavoured
    hill climb). After each window executes, :meth:`observe` is fed the
    window's op count, conflict-pin count, and measured DB round trips:

      * a high pin rate means the window is wasting reordering freedom on
        conflicting mutations — SHRINK (less speculative lookahead, lower
        client-observed latency);
      * otherwise, if round-trips-per-op held steady or improved, the
        batching amortization is paying — GROW toward ``max_window``;
      * a regressing round-trip rate backs off.

    Deterministic (no randomness), clamped to [min_window, max_window],
    so planned runs stay reproducible. The same controller drives the
    DES mirror (``cluster_sim.BatchedHopsFSSim(adaptive=True)``).

    Since the elastic pool, the controller optionally drives a SECOND
    knob: per-namenode ``batch_size``, AIMD-adapted from the measured
    lock-wait fraction (``LockManager.wait_count / acquire_count`` over
    the window). Bigger batches mean longer grouped transactions holding
    more row locks at once; when peers start *waiting* on those locks the
    batch is the contention amplifier, so it backs off multiplicatively
    (divide by ``factor``) and regrows additively (``batch_step``) while
    contention stays under ``contention_shrink`` — classic AIMD, applied
    to transaction footprint instead of flow rate. Pass ``batch_base``
    to enable; without it the knob is inert and ``observe`` behaves
    exactly as before."""

    def __init__(self, base: int, *, min_window: int, max_window: int,
                 pin_shrink: float = 0.35, factor: int = 2,
                 rt_slack: float = 1.05, batch_base: Optional[int] = None,
                 min_batch: int = 1, max_batch: Optional[int] = None,
                 contention_shrink: float = 0.05, batch_step: int = 1):
        self.window = max(1, base)
        self.min_window = max(1, min_window)
        self.max_window = max(self.min_window, max_window)
        self.pin_shrink = pin_shrink
        self.factor = max(2, factor)
        self.rt_slack = rt_slack
        self._last_rt_per_op: Optional[float] = None
        self.history: List[int] = [self.window]
        # the batch-size knob (None = not controlled)
        self.batch_size: Optional[int] = (max(1, batch_base)
                                          if batch_base is not None else None)
        self.min_batch = max(1, min_batch)
        self.max_batch = (max(self.min_batch, max_batch)
                          if max_batch is not None
                          else (self.batch_size * 4
                                if self.batch_size is not None else None))
        self.contention_shrink = contention_shrink
        self.batch_step = max(1, batch_step)
        self.batch_history: List[int] = (
            [self.batch_size] if self.batch_size is not None else [])

    def observe(self, ops: int, pinned: int, round_trips: int,
                *, lock_wait_frac: float = 0.0) -> int:
        if ops <= 0:
            return self.window
        pin_rate = pinned / ops
        rt_per_op = round_trips / ops
        if pin_rate > self.pin_shrink:
            self.window = max(self.min_window, self.window // self.factor)
        elif (self._last_rt_per_op is None
              or rt_per_op <= self._last_rt_per_op * self.rt_slack):
            self.window = min(self.max_window, self.window * self.factor)
        else:
            self.window = max(self.min_window, self.window // self.factor)
        self._last_rt_per_op = rt_per_op
        self.history.append(self.window)
        if self.batch_size is not None:
            if lock_wait_frac > self.contention_shrink:
                self.batch_size = max(self.min_batch,
                                      self.batch_size // self.factor)
            else:
                self.batch_size = min(self.max_batch,  # type: ignore[arg-type]
                                      self.batch_size + self.batch_step)
            self.batch_history.append(self.batch_size)
        return self.window


@dataclass
class PlannedBatch:
    """One dealt batch: trace indices, their client-side resolutions, the
    namenode slot the dominant partition routes to, and whether the batch
    is order-pinned (conflicting mutations: must run in plan order).
    Lease-ordered same-key runs are never split across batches, so a batch
    is always an atomic unit of per-file block-write ordering; ``mutates``
    marks batches carrying any mutation — concurrent workers never steal
    those, so a partition's writes always land on its home namenode
    (warm hint cache, stable grouped-write engagement)."""
    indices: List[int]
    hints: List[Optional[PlanHint]]
    nn_slot: int
    ordered: bool = False
    mutates: bool = False


@dataclass
class PlanReport:
    """Planner telemetry for the benchmark report. ``predicted_local`` /
    ``predicted_total`` come from the kernel's per-component partitions:
    the share of an op's own row accesses expected to land on its
    coordinator's node group — the client-side forecast of the measured
    ``local_rt`` split (§7.7). The ``client_*`` fields are the closed-loop
    hint telemetry: probe-level hits on the client's own response-warmed
    cache vs fallback hits on the merged namenode caches vs misses, plus
    staleness evidence (absorbed hints contradicting cached ids, and
    client-side invalidations on destructive ops)."""
    ops: int = 0
    planned_ops: int = 0        # ops dealt with a client-side resolution
    pinned_ops: int = 0         # mutations kept in submission order
    lease_ordered_ops: int = 0  # block writes kept FREE under lease order:
                                # same-file collisions that would have
                                # pinned, held in submission order by the
                                # stable (partition, type, i) sort instead
    windows: int = 0
    batches: int = 0
    kernel_launches: int = 0    # fused phash_chain calls that succeeded
    hintchain_launches: int = 0  # fused hint-chain resolution launches
    pkval_launches: int = 0     # fused grouped-PK validation launches
    pkval_probes: int = 0       # composite-PK probes validated in them
    pkval_demotions: int = 0    # resolved ops demoted by stale chains
    partitions_seen: Set[int] = field(default_factory=set)
    predicted_local: int = 0
    predicted_total: int = 0
    # closed-loop client hint-cache telemetry (probe-level)
    client_hits: int = 0
    client_fallback_hits: int = 0
    client_misses: int = 0
    client_stale: int = 0          # absorbed hints contradicting cached ids
    client_invalidations: int = 0  # destructive-op invalidations
    hint_routed_batches: int = 0   # batches dealt to a warm namenode
                                   # instead of the partition-hash slot
    deadline_shed: int = 0         # ops never dealt: deadline already past
    breaker_rerouted: int = 0      # batches moved off an open-breaker slot
    window_sizes: List[int] = field(default_factory=list)

    @property
    def predicted_local_share(self) -> float:
        return (self.predicted_local / self.predicted_total
                if self.predicted_total else 0.0)

    @property
    def hint_hit_rate(self) -> float:
        """Share of resolver probes answered by the CLIENT's own cache —
        the closed-loop win: >0 means responses, not namenode-cache reads,
        are resolving paths."""
        probes = self.client_hits + self.client_fallback_hits \
            + self.client_misses
        return self.client_hits / probes if probes else 0.0


def _chain_partitions_scalar(ct: ColumnarTrace, n_partitions: int
                             ) -> Tuple[Any, Any, Any]:
    """The fused chain hash on the host, one scalar store hash per key —
    what windows below the kernel's size gate use."""
    n, depth = ct.parent_ids.shape
    comp = np.zeros((n, depth), np.int32)
    hint_parts = np.zeros(n, np.int32)
    sigs = np.zeros(n, np.uint32)
    for i in range(n):
        sig = 0
        for d in range(depth):
            h = _hash_key(int(ct.parent_ids[i, d]) & 0xFFFFFFFF)
            comp[i, d] = h % n_partitions
            if d < int(ct.depths[i]):
                step = ((sig ^ h ^ (int(ct.name_hashes[i, d]) & 0xFFFFFFFF))
                        * 0x85EBCA6B) & 0xFFFFFFFF
                sig = step ^ (step >> 15)
        hint_parts[i] = _hash_key(int(ct.hint_ids[i]) & 0xFFFFFFFF) \
            % n_partitions
        sigs[i] = sig
    return comp, hint_parts, sigs


def _chain_partitions(ct: ColumnarTrace, n_partitions: int, *,
                      device: Any) -> Tuple[Any, Any, Any, bool]:
    """One fused ``phash_chain`` launch on ``device`` for a window of at
    least ``PHASH_MIN_BATCH`` ops, the scalar store hash below it — the
    same size gate as the namenodes' own ``_partitions_for``, with
    identical results either way."""
    if ct.n < max(2, PHASH_MIN_BATCH):
        return (*_chain_partitions_scalar(ct, n_partitions), False)
    from ..kernels.phash.ops import phash_chains
    return (*phash_chains(ct.parent_ids, ct.name_hashes, ct.hint_ids,
                          ct.depths, n_partitions, device=device), True)


class BatchPlanner:
    """Plans a trace into partition-aligned, type-sorted batches.

    ``window`` ops are planned at a time (default: enough for several
    batches per alive namenode); planning never moves an op across a
    window boundary, which bounds both reordering distance and the
    columnar working set. Under ``adaptive=True`` the window is live: the
    pipeline reports each executed window back through
    :meth:`observe_window` and the :class:`WindowController` resizes it.

    ``client_cache`` closes the loop: resolution probes hit the client's
    own response-warmed cache first (:class:`HintResolver`), with the
    merged namenode caches (:class:`MultiCacheResolver`) as fallback.
    Without one, the planner degrades to the PR-3 behaviour of reading
    namenode caches directly.
    """

    def __init__(self, cluster: NamenodeCluster, *, batch_size: int = 16,
                 window: Optional[int] = None,
                 pin_all_mutations: bool = False,
                 client_cache: Optional[InodeHintCache] = None,
                 adaptive: bool = False, hint_routing: bool = False,
                 breakers: Any = None):
        self.cluster = cluster
        self.batch_size = max(1, batch_size)
        n_slots = max(1, len(cluster.alive_namenodes()))
        self.n_slots = n_slots
        self.hint_routing = hint_routing
        #: optional admission.BreakerBoard — dealing skips namenodes
        #: whose circuit breaker is open (gray-failure protection)
        self.breakers = breakers
        #: indices the LAST plan_window refused to deal because their
        #: deadline already passed (the pipeline marks them shed)
        self.deadline_shed: List[int] = []
        base = window or self.batch_size * n_slots * 8
        self.window = base
        self.controller: Optional[WindowController] = (
            WindowController(base, min_window=self.batch_size,
                             max_window=base * 4,
                             batch_base=self.batch_size,
                             min_batch=max(1, self.batch_size // 8))
            if adaptive else None)
        # pin_all_mutations survives as an explicit conservative mode (and
        # for A/B tests); the closed-loop pipeline no longer needs it in
        # concurrent mode — windows are execution barriers there, so
        # window-scoped conflict analysis is sound (see
        # PlannedRequestPipeline).
        self.pin_all_mutations = pin_all_mutations
        self.client_cache = client_cache
        self._resolver: Optional[HintResolver] = (
            HintResolver(client_cache) if client_cache is not None else None)
        # the cache persists across runs (and is shared with a DFSClient),
        # so per-run telemetry must be DELTAS against its lifetime
        # counters at planner construction
        self._stale0 = client_cache.stale_overwrites \
            if client_cache is not None else 0
        self._inv0 = client_cache.invalidations \
            if client_cache is not None else 0
        self.report = PlanReport()

    # -- conflict pinning ----------------------------------------------
    @staticmethod
    def _mutation_paths(wop: WorkloadOp, spec: Any
                       ) -> List[Tuple[str, ...]]:
        if spec is None:
            return [tuple(split_path(wop.path))]
        # OpSpec.path_args applies rename's implicit ".mv" destination —
        # the one canonical place that rule lives
        return [tuple(split_path(p)) for p in spec.path_args(wop)]

    def _pin_conflicts(self, wops: Sequence[WorkloadOp],
                       idxs: Sequence[int]
                       ) -> Tuple[Set[int], Set[int], Dict[int, Any]]:
        """Pin every mutation whose path collides with another mutation's
        path in the window — equality, or prefix in either direction (a
        ``mkdirs`` below a path another op creates/deletes must not cross
        it). Checked exactly on the (minority) mutation set's component
        tuples; read-only ops are never pinned.

        Lease-ordered exception (the block-write window rule): same-path
        collisions where EVERY colliding mutation is the same lease-ordered
        op type with the same ``OpSpec.lease_order`` key (e.g. a run of
        add_blocks growing one hot file) stay FREE — the deal's
        submission-stable (partition, type, i) sort already keeps
        same-file ops in submission order (same file ⇒ same hint
        partition and same type), so they can batch with block writes to
        other files instead of being exiled to the ordered queue. Any
        mixed-type or mixed-key collision pins conservatively.

        Returns (pinned, lease_freed, lease_key_of): the pinned set, the
        ops freed under the lease exception, and each freed op's lease
        key — the deal never splits a same-key run across batches, which
        is what makes the exception safe under concurrent execution."""
        muts: List[Tuple[int, Any, List[Tuple[str, ...]]]] = []
        for i in idxs:
            spec = REGISTRY.get(wops[i].op)
            if spec is not None and spec.read_only:
                continue
            muts.append((i, spec, self._mutation_paths(
                wops[i], spec) if spec is not None else []))
        path_count: Dict[Tuple[str, ...], int] = {}
        prefix_count: Dict[Tuple[str, ...], int] = {}
        # per colliding path: the (op name, lease-order key) pairs of its
        # mutations — freeing requires ONE pair, with a real key
        ops_on_path: Dict[Tuple[str, ...], Set[Tuple[str, Any]]] = {}
        for i, spec, paths in muts:
            name = spec.name if spec is not None else "?"
            key = (spec.lease_order(wops[i])
                   if spec is not None and spec.lease_order is not None
                   else None)
            for p in paths:
                path_count[p] = path_count.get(p, 0) + 1
                ops_on_path.setdefault(p, set()).add((name, key))
                for k in range(1, len(p)):
                    pref = p[:k]
                    prefix_count[pref] = prefix_count.get(pref, 0) + 1
        pinned: Set[int] = set()
        lease_freed: Set[int] = set()
        lease_key_of: Dict[int, Any] = {}
        for i, spec, paths in muts:
            # unknown/0-path ops cannot be reasoned about; destructive ops
            # (delete/rename/truncate/concat) must never be hopped over by
            # a read that the trace issued before them: keep in order.
            # pin_all_mutations (explicit conservative mode) pins every
            # mutation.
            if self.pin_all_mutations or spec is None or spec.paths == 0 \
                    or spec.destructive:
                pinned.add(i)
                continue
            freed = False
            for p in paths:
                if prefix_count.get(p, 0) > 0 \
                        or any(p[:k] in path_count
                               for k in range(1, len(p))):
                    pinned.add(i)
                    break
                if path_count.get(p, 0) > 1:
                    pairs = ops_on_path[p]
                    if len(pairs) == 1 and spec.lease_order is not None \
                            and next(iter(pairs))[1] is not None:
                        freed = True            # same-file, same-key run
                        continue
                    pinned.add(i)
                    break
            if freed and i not in pinned:
                lease_freed.add(i)
                lease_key_of[i] = spec.lease_order(wops[i])
        return pinned, lease_freed, lease_key_of

    def _routable_slot(self, slot: int, alive: Sequence[Any]) -> int:
        """Breaker-aware dealing (docs/ROBUSTNESS.md): skip slots whose
        namenode has an OPEN circuit breaker — a tripped namenode stops
        receiving free chunks — falling to the deterministic next slot.
        Half-open breakers admit exactly their probe budget (``routable``
        consumes a probe per dealt batch). If the whole fleet tripped,
        the original slot is kept: routing must proceed somewhere, and
        the breakers re-probe as their reset timers expire."""
        if self.breakers is None or not alive:
            return slot
        n = len(alive)
        slot %= n
        for d in range(n):
            k = (slot + d) % n
            if self.breakers.routable(alive[k].nn_id):
                if d:
                    self.report.breaker_rerouted += 1
                return k
        return slot

    @staticmethod
    def _warm_slot(path: str, alive: Sequence[Any]) -> Optional[int]:
        """Slot index (into the alive list) of the first namenode whose
        hint cache resolves ``path``'s full chain — side-effect-free
        peeks, mirroring ``RequestPipeline._warm_namenode``."""
        from .tables import ROOT_ID
        comps = split_path(path)
        if not comps:
            return None
        for k, nn in enumerate(alive):
            cache = nn.ops.cache
            if cache is None:
                continue
            parent: Optional[int] = ROOT_ID
            for name in comps:
                parent = cache.peek(parent, name)
                if parent is None:
                    break
            if parent is not None:
                return k
        return None

    # -- planning -------------------------------------------------------
    def plan_window(self, wops: Sequence[WorkloadOp], lo: int, hi: int
                    ) -> List[PlannedBatch]:
        """Plan ONE window of the trace (global indices [lo, hi)). The
        closed-loop pipeline calls this per window — executing and
        absorbing response hints between calls — so each window resolves
        against the freshest client cache state."""
        n_partitions = self.cluster.store.n_partitions
        # membership is LIVE under the elastic pool: re-derive the slot
        # count per window so dealt batches spread over the namenodes
        # alive NOW (on a static fleet this is the frozen constructor
        # value). run_window maps slots onto the current alive list, so
        # a fleet that shrank between plan and execute stays safe.
        alive = self.cluster.alive_namenodes()
        self.n_slots = max(1, len(alive))
        fallback = MultiCacheResolver.of_cluster(self.cluster)
        if self._resolver is not None:
            self._resolver.fallback = fallback
            resolver: Any = self._resolver
        else:
            resolver = fallback
        batches: List[PlannedBatch] = []
        self.report.ops += hi - lo
        window = list(range(lo, hi))
        # deadline-aware dealing: deal only ops that can still make
        # their deadline — expired ops are shed client-side, sparing the
        # fleet a round trip that could not produce useful work
        now = self.cluster.election.now
        self.deadline_shed = [i for i in window
                              if wops[i].deadline is not None
                              and now > wops[i].deadline]
        if self.deadline_shed:
            self.report.deadline_shed += len(self.deadline_shed)
            expired = set(self.deadline_shed)
            window = [i for i in window if i not in expired]
        if not window:
            self.report.windows += 1
            self.report.window_sizes.append(hi - lo)
            self._refresh_client_telemetry()
            return batches
        # fused hint-chain resolution: one hintchain launch walks every
        # op's cached parent chain (bit-equivalent to the Python loop,
        # which small windows and non-HintResolver resolvers fall back to)
        ct, used_hintchain = lower_trace_fused(
            [wops[i] for i in window], resolver,
            device=self.cluster.store.device)
        if used_hintchain:
            self.report.hintchain_launches += 1
        # grouped-batch PK validation: one pkval launch checks every
        # client-resolved chain against the columnar store's hash index;
        # stale chains are demoted BEFORE the conflict/pinning pass so
        # they ride the exact sequential path (dict backend: no-op)
        validated = validate_window_pks(self.cluster.store, ct)
        if validated is not None:
            demoted, n_probes, used_pkval = validated
            self.report.pkval_probes += n_probes
            if used_pkval:
                self.report.pkval_launches += 1
            for k in demoted:
                self.report.pkval_demotions += 1
                ct.resolved[k] = False
                ct.pks[k] = None
                ct.target_ids[k] = None
        # _sigs: the kernel's path-equality probe, no consumer here yet
        comp_parts, hint_parts, _sigs, used_kernel = _chain_partitions(
            ct, n_partitions, device=self.cluster.store.device)
        if used_kernel:
            self.report.kernel_launches += 1
        pinned, lease_freed, lease_key_of = self._pin_conflicts(wops, window)
        # ops whose chain did NOT resolve client-side stay in
        # submission order too — an unresolved read (or create) may
        # target a path another op in this window creates, and
        # hopping over that op would spuriously fail it. Unresolved
        # ops cannot group anyway, so ordering them costs nothing.
        for k, i in enumerate(window):
            if not ct.resolved[k]:
                pinned.add(i)
                lease_freed.discard(i)
        self.report.lease_ordered_ops += len(lease_freed)
        hints: Dict[int, Optional[PlanHint]] = {}
        parts: Dict[int, int] = {}
        n_groups = self.cluster.store.n_groups
        for k, i in enumerate(window):
            parts[i] = int(hint_parts[k])
            self.report.partitions_seen.add(parts[i])
            if ct.resolved[k]:
                hints[i] = PlanHint(pks=ct.pks[k],
                                    target_id=ct.target_ids[k],
                                    hint_id=int(ct.hint_ids[k]))
                self.report.planned_ops += 1
                # client-side locality forecast: which of this op's
                # component rows share the coordinator's node group
                d = int(ct.depths[k])
                coord_g = parts[i] % n_groups
                self.report.predicted_local += sum(
                    1 for j in range(d)
                    if int(comp_parts[k, j]) % n_groups == coord_g)
                self.report.predicted_total += d
            else:
                hints[i] = None
        type_of = {i: int(ct.type_ids[k])
                   for k, i in enumerate(window)}
        # free ops: partition-aligned, type-sorted, submission-stable.
        # Lease-freed ops are anchored at their key's FIRST submission
        # index, so one file's block-write run is contiguous in the deal
        # order even when another same-partition file's ops interleave
        # with it in the trace — without the anchor, the cut-extension
        # below could not keep such a run whole (its pieces could land in
        # batches routed to different slots and execute concurrently).
        # Reordering across distinct keys is safe: freed ops collide only
        # within their own key, and within a key the i tiebreak keeps
        # submission order.
        anchor: Dict[int, int] = {}
        first_of_key: Dict[Any, int] = {}
        for i in sorted(lease_freed):
            k = lease_key_of[i]
            first_of_key.setdefault(k, i)
            anchor[i] = first_of_key[k]
        free = [i for i in window if i not in pinned]
        free.sort(key=lambda i: (parts[i], type_of[i],
                                 anchor.get(i, i), i))
        c = 0
        while c < len(free):
            end = min(c + self.batch_size, len(free))
            # never cut inside a lease-ordered same-key run: all block
            # writes to one file land in ONE (possibly oversized) batch,
            # executed by one namenode in submission order — so
            # concurrent workers (and work stealing) can never interleave
            # same-file block writes, while distinct files still deal to
            # distinct batches and run concurrently
            while 0 < end < len(free) and free[end - 1] in lease_freed \
                    and free[end] in lease_freed \
                    and lease_key_of[free[end - 1]] \
                    == lease_key_of[free[end]]:
                end += 1
            chunk = free[c:end]
            c = end
            slot = parts[chunk[0]] % self.n_slots
            if self.hint_routing and len(alive) > 1:
                # deal to the namenode already warm for this chunk's lead
                # path; the partition hash stays the cold-path fallback
                warm = self._warm_slot(wops[chunk[0]].path, alive)
                if warm is not None:
                    slot = warm
                    self.report.hint_routed_batches += 1
            slot = self._routable_slot(slot, alive)
            mutates = any(
                (s := REGISTRY.get(wops[i].op)) is None or not s.read_only
                for i in chunk)
            batches.append(PlannedBatch(
                indices=chunk, hints=[hints[i] for i in chunk],
                nn_slot=slot, mutates=mutates))
        # pinned mutations LAST, strictly in submission order: free
        # reads of a window never spuriously fail against a
        # destructive op the trace issued later (a read the trace
        # issued after the delete may now succeed instead — benign,
        # final state is unaffected by reads)
        pin_order = [i for i in window if i in pinned]
        self.report.pinned_ops += len(pin_order)
        pin_slot = self._routable_slot(0, alive)
        for c in range(0, len(pin_order), self.batch_size):
            chunk = pin_order[c:c + self.batch_size]
            batches.append(PlannedBatch(
                indices=chunk, hints=[hints[i] for i in chunk],
                nn_slot=pin_slot, ordered=True))
        self.report.windows += 1
        self.report.window_sizes.append(hi - lo)
        self.report.batches += len(batches)
        self._refresh_client_telemetry()
        return batches

    def _refresh_client_telemetry(self) -> None:
        """Copy the resolver's probe counters (per-planner, so per-run)
        and the cache's staleness counters (per-run DELTAS — the cache
        outlives runs) into the report."""
        if self._resolver is not None:
            self.report.client_hits = self._resolver.hits
            self.report.client_fallback_hits = self._resolver.fallback_hits
            self.report.client_misses = self._resolver.misses
        if self.client_cache is not None:
            self.report.client_stale = \
                self.client_cache.stale_overwrites - self._stale0
            self.report.client_invalidations = \
                self.client_cache.invalidations - self._inv0

    def observe_window(self, *, ops: int, pinned: int,
                       round_trips: int,
                       lock_wait_frac: float = 0.0) -> int:
        """Close the feedback loop after a window executed (and its hints
        were absorbed): the controller resizes the live window from the
        observed pin rate and measured round trips per op (no-op on a
        fixed window), and the client telemetry snapshot is refreshed so
        the final window's absorptions are counted too.
        ``lock_wait_frac`` is the window's measured lock-wait fraction
        (store-level ``wait_count``/``acquire_count`` deltas) — the signal
        the controller's second knob AIMD-adapts ``batch_size`` from."""
        self._refresh_client_telemetry()
        if self.controller is not None:
            self.window = self.controller.observe(
                ops, pinned, round_trips, lock_wait_frac=lock_wait_frac)
            if self.controller.batch_size is not None:
                self.batch_size = self.controller.batch_size
        return self.window

    def plan(self, wops: Sequence[WorkloadOp]) -> List[PlannedBatch]:
        """Plan a whole trace at the current (fixed) window size — the
        open-loop entry point, kept for direct planner use and tests. The
        closed-loop pipeline drives :meth:`plan_window` instead."""
        batches: List[PlannedBatch] = []
        for lo in range(0, len(wops), self.window):
            batches.extend(
                self.plan_window(wops, lo, min(lo + self.window,
                                               len(wops))))
        return batches


class PlannedRequestPipeline(RequestPipeline):
    """A :class:`RequestPipeline` whose dealing is driven by the client-side
    plan instead of FIFO slicing: each namenode receives partition-aligned,
    type-sorted batches with planner hints attached, so ``execute_batch``
    sees maximal groupable runs (reads AND group-mutable writes) and its
    shared transactions land on their coordinator's node group.

    The run loop is **closed-loop per window**: plan one window against
    the client's own hint cache, execute its batches, absorb the
    response-piggybacked hints (and invalidate on destructive ops), let
    the :class:`WindowController` resize the window, then plan the next.
    Windows are therefore execution BARRIERS, which is what makes
    window-scoped conflict analysis sound in concurrent mode — conflicts
    cannot span windows because no two windows are ever in flight at once.

    ``concurrent=False`` executes batches in plan order (deterministic);
    ``concurrent=True`` runs one worker per alive namenode over per-slot
    queues WITHIN each window — order-pinned batches all live on one
    queue, preserving their relative order, and same-file block-write runs
    are never split across batches (lease order), so distinct-file block
    writes group concurrently while same-path collisions stay ordered.
    Ops on a namenode that dies mid-batch fail over to the survivors
    exactly like the reactive pipeline (§7.6.1)."""

    def __init__(self, cluster: NamenodeCluster, *, batch_size: int = 16,
                 concurrent: bool = False, window: Optional[int] = None,
                 client_cache: Optional[InodeHintCache] = None,
                 adaptive: bool = True, pool: Any = None,
                 hint_routing: Optional[bool] = None,
                 admission: Any = None, breakers: Any = None):
        super().__init__(cluster, batch_size=batch_size,
                         concurrent=concurrent)
        self.window = window
        self.adaptive = adaptive
        #: optional admission.AdmissionController — fed the remaining
        #: queue depth per window (its pressure signal); the controller
        #: itself must be install()ed on the cluster by the caller
        self.admission = admission
        #: optional admission.BreakerBoard — batches are dealt away from
        #: open-breaker namenodes and every batch outcome is recorded
        self.breakers = breakers
        #: the client-side hint cache, persistent across run() calls (and
        #: shareable with a DFSClient so facade calls warm it too)
        self.client_cache = (client_cache if client_cache is not None
                             else InodeHintCache())
        #: elastic pool driving membership (optional): ticked once per
        #: executed window with the remaining queue depth so scale
        #: decisions ride the replay's own logical clock
        self.pool = pool
        # warm-NN routing defaults ON exactly when membership is elastic —
        # a pool invalidates the static partition→namenode affinity, and
        # on a fixed fleet the partition hash already IS the warm slot
        self.hint_routing = (hint_routing if hint_routing is not None
                             else pool is not None)
        self.planner: Optional[BatchPlanner] = None

    @property
    def plan_report(self) -> Optional[PlanReport]:
        return self.planner.report if self.planner else None

    # -- closing the loop ----------------------------------------------
    def _absorb_window(self, wops: Sequence[WorkloadOp],
                       outcomes: Sequence[Optional[OpOutcome]],
                       lo: int, hi: int) -> int:
        """Absorb the executed window's piggybacked hints into the client
        cache (the shared :func:`~repro_torch.core.hint_cache.absorb_response`
        rule: invalidate-on-destructive per op, then warm), and return
        the window's measured DB round trips for the controller."""
        round_trips = 0
        for i in range(lo, hi):
            oc = outcomes[i]
            if oc is None or not oc.ok:
                continue
            round_trips += oc.result.cost.round_trips
            absorb_response(self.client_cache, wops[i],
                            REGISTRY.get(wops[i].op), oc.result.hints)
        return round_trips

    def run(self, wops: Sequence[WorkloadOp]) -> PipelineStats:
        import time
        wops = list(wops)
        if not self.cluster.alive_namenodes():
            raise StoreError("no alive namenodes")
        self.planner = BatchPlanner(self.cluster,
                                    batch_size=self.batch_size,
                                    window=self.window,
                                    client_cache=self.client_cache,
                                    adaptive=self.adaptive,
                                    hint_routing=self.hint_routing,
                                    breakers=self.breakers)
        planner = self.planner
        outcomes: List[Optional[OpOutcome]] = [None] * len(wops)
        residual: deque = deque()      # ops orphaned by namenode deaths
        rlock = threading.Lock()
        n_batches = [0]
        cost0 = {nn.nn_id: nn.agg_cost.copy()
                 for nn in self.cluster.namenodes}
        served0 = {nn.nn_id: nn.ops_served
                   for nn in self.cluster.namenodes}

        def run_batch(nn, batch: PlannedBatch) -> bool:
            """Execute one planned batch; False if the namenode died (its
            unfinished ops go to the residual queue)."""
            try:
                res = nn.execute_batch([wops[i] for i in batch.indices],
                                       hints=batch.hints)
            except StoreError:
                if self.breakers is not None:
                    self.breakers.record(nn.nn_id, ok=False)
                with rlock:
                    residual.extend(batch.indices)
                return False
            died = []
            for i, oc in zip(batch.indices, res):
                if not oc.ok and oc.error == "StoreError" and not nn.alive:
                    died.append(i)
                else:
                    outcomes[i] = oc
            if self.breakers is not None:
                # transport-class outcomes trip the breaker; genuine FS
                # outcomes count as proof of health
                from .admission import BREAKER_FAILURES
                sick = bool(died) or any(
                    oc is not None and not oc.ok
                    and oc.error in BREAKER_FAILURES for oc in res)
                self.breakers.record(nn.nn_id, ok=not sick)
            if died:
                with rlock:
                    residual.extend(died)
            with rlock:
                n_batches[0] += 1
            return not died

        def run_window(batches: List[PlannedBatch]) -> None:
            if not self.concurrent:
                for batch in batches:
                    alive = self.cluster.alive_namenodes()
                    if not alive:
                        return
                    run_batch(alive[batch.nn_slot % len(alive)], batch)
                return
            alive = self.cluster.alive_namenodes()
            if not alive:
                return
            # free batches fan out across one worker per namenode;
            # order-pinned batches run AFTER the workers join, exactly
            # where deterministic mode runs them (last in the window) —
            # pinned mutations therefore observe the same pre-state in
            # both modes
            free_batches = [b for b in batches if not b.ordered]
            queues: List[deque] = [deque() for _ in alive]
            qlock = threading.Lock()
            for batch in free_batches:
                queues[batch.nn_slot % len(alive)].append(batch)

            def pull(k: int) -> Optional[PlannedBatch]:
                with qlock:
                    if queues[k]:
                        return queues[k].popleft()
                    # steal READ-ONLY work, longest donor first —
                    # mutating batches stay on their home slot so a
                    # partition's writes always hit the namenode whose
                    # hint cache is warm for it (grouped-write engagement
                    # matches deterministic mode); a non-stealable tail
                    # must not blind us to other donors
                    for j in sorted(range(len(queues)),
                                    key=lambda q: -len(queues[q])):
                        if queues[j] and not queues[j][-1].mutates:
                            return queues[j].pop()
                    return None

            def drain(k: int, nn) -> None:
                while True:
                    batch = pull(k)
                    if batch is None:
                        return
                    if not run_batch(nn, batch):
                        with qlock:                     # orphan my queue
                            while queues[k]:
                                b = queues[k].popleft()
                                with rlock:
                                    residual.extend(b.indices)
                        return

            workers = [threading.Thread(target=drain, args=(k, nn))
                       for k, nn in enumerate(alive)]
            for w in workers:
                w.start()
            for w in workers:
                w.join()
            for batch in batches:
                if not batch.ordered:
                    continue
                alive = self.cluster.alive_namenodes()
                if not alive:
                    return
                run_batch(alive[batch.nn_slot % len(alive)], batch)

        def drain_residual() -> None:
            # failover pass: re-deal orphaned ops to survivors, reactive
            while residual:
                alive = self.cluster.alive_namenodes()
                if not alive:
                    return
                idxs = [residual.popleft()
                        for _ in range(min(self.batch_size,
                                           len(residual)))]
                run_batch(alive[n_batches[0] % len(alive)],
                          PlannedBatch(indices=idxs,
                                       hints=[None] * len(idxs),
                                       nn_slot=0))

        locks = self.cluster.store.locks
        t0 = time.perf_counter()
        lo = 0
        while lo < len(wops):
            if not self.cluster.alive_namenodes():
                break
            hi = min(lo + planner.window, len(wops))
            if self.admission is not None:
                # backlog report: the admission controllers' pressure
                # signal for WFQ load shedding
                self.admission.observe_queue(len(wops) - lo)
            pinned_before = planner.report.pinned_ops
            w0, a0 = locks.wait_count, locks.acquire_count
            batches = planner.plan_window(wops, lo, hi)
            # ops the planner refused to deal (deadline already passed)
            # are shed client-side — no round trip, no execution
            for i in planner.deadline_shed:
                outcomes[i] = OpOutcome(None, "DeadlineExpired")
            run_window(batches)
            drain_residual()
            rts = self._absorb_window(wops, outcomes, lo, hi)
            acquired = locks.acquire_count - a0
            planner.observe_window(
                ops=hi - lo,
                pinned=planner.report.pinned_ops - pinned_before,
                round_trips=rts,
                lock_wait_frac=((locks.wait_count - w0) / acquired
                                if acquired else 0.0))
            self.batch_size = planner.batch_size
            if self.pool is not None:
                self.pool.tick(queue_depth=len(wops) - hi)
            lo = hi
        wall = time.perf_counter() - t0
        for i, oc in enumerate(outcomes):
            if oc is None:
                outcomes[i] = OpOutcome(None, "StoreError")
        return self._finalize_stats(wops, outcomes, cost0, served0, wall,
                                    n_batches[0])
