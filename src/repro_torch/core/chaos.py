"""Deterministic chaos fault injection + recovery invariants (§7.6).

The paper's robustness claim — "failure of the leader or any other
namenode does not result in a metadata service downtime" (§7.6) — is a
statement about the WHOLE write path: grouped transactions abort cleanly,
clients fail over, the election detects the death, subtree locks and
leases held by the dead namenode are reclaimed, and the namespace
converges to exactly the state a fault-free run would have produced.

This module makes that claim testable, deterministically:

  FaultSite     — named injection points threaded through the write path
                  (grouped-txn lock phase, subtree chunk commits, batch
                  exchanges, heartbeats).
  ChaosPlan     — a schedule of faults: (site, occurrence index, victim,
                  kind).  Plans are plain frozen data, so hypothesis can
                  generate and SHRINK them; ``ChaosPlan.seeded`` derives a
                  plan from an integer seed for fixed-seed regressions.
  FaultInjector — interprets a plan against a live NamenodeCluster.  A
                  ``crash`` marks the victim dead (it stops heartbeating;
                  its in-flight transaction aborts) and raises StoreError
                  exactly where the site fired; a ``partition`` raises
                  :class:`~repro_torch.core.store.NetworkPartition` on the next
                  ``heal_after`` client exchanges with the victim.
  RecoveryInvariants — the convergence oracle: namespace equality vs a
                  fault-free sequential replay, conserved OpCost, zero
                  orphan lease/under_construction/block rows, LockManager
                  fully released.
  replay_with_recovery — drives a trace through a pipeline under
                  injection, then runs the client-visible recovery
                  protocol (tick past the heartbeat staleness bound,
                  leader lease sweep, re-drive failed ops on survivors)
                  until the outcome set converges.

Host modules never import this one — injection points are ``chaos``
attributes (default ``None``) the injector installs, so the hot path
costs one attribute check when chaos is off.
"""
from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .ops_registry import WorkloadOp
from .store import MetadataStore, NetworkPartition, OpCost, StoreError


class FaultSite(str, Enum):
    """Named injection points, in write-path order.  The string values are
    what host modules pass to :meth:`FaultInjector.fire` (they must not
    import this module)."""
    #: entry of Namenode.perform/invoke — one client RPC
    RPC = "rpc"
    #: entry of Namenode.execute_batch — one pipeline batch exchange
    #: (RequestPipeline and PlannedRequestPipeline both land here)
    BATCH_EXCHANGE = "batch_exchange"
    #: Namenode._write_group_txn, before the single lock-phase exchange
    GROUP_TXN_PRE_LOCK = "group_txn_pre_lock"
    #: Namenode._write_group_txn, locks held, before the EXECUTE phase
    GROUP_TXN_POST_LOCK = "group_txn_post_lock"
    #: SubtreeOps.delete_subtree, between phase-3 chunk commits (§6.2)
    SUBTREE_CHUNK = "subtree_chunk"
    #: LeaderElection.heartbeat — the victim's liveness proof itself
    HEARTBEAT = "heartbeat"


#: sites where a client↔namenode exchange happens (partitionable)
PARTITIONABLE = (FaultSite.RPC, FaultSite.BATCH_EXCHANGE)

CRASH = "crash"
PARTITION = "partition"
#: gray failure: the victim stays alive and heartbeating but every
#: exchange with it burns ``delay_ticks`` of the shared logical clock —
#: the "limping but not dead" server the crash/partition kinds can't
#: model. Heals after ``heal_after`` slowed exchanges.
DELAY = "delay"


@dataclass(frozen=True)
class Fault:
    """One scheduled fault: at the ``at``-th firing of ``site`` (counted
    per site, 0-based) on a namenode matching ``victim`` (None = any),
    inject ``kind``.  Partitions heal after ``heal_after`` refused
    exchanges and delays after ``heal_after`` slowed ones, so every
    plan terminates."""
    site: FaultSite
    at: int = 0
    victim: Optional[int] = None
    kind: str = CRASH
    heal_after: int = 3
    #: DELAY only: logical-clock ticks each slowed exchange burns
    delay_ticks: int = 2

    def __post_init__(self) -> None:
        assert self.kind in (CRASH, PARTITION, DELAY), self.kind
        assert self.at >= 0
        if self.kind == PARTITION:
            assert FaultSite(self.site) in PARTITIONABLE, \
                f"partition only makes sense at a client exchange, " \
                f"not {self.site}"
            assert self.heal_after >= 1, "partitions must heal"
        if self.kind == DELAY:
            # a slow heartbeat is indistinguishable from a missed one in
            # this model (the election already covers that); DELAY models
            # slow WORK, so it lives at the request-path sites
            assert FaultSite(self.site) is not FaultSite.HEARTBEAT, \
                "delay faults fire on the request path, not heartbeats"
            assert self.heal_after >= 1, "delays must heal"
            assert self.delay_ticks >= 1


@dataclass(frozen=True)
class ChaosPlan:
    """A deterministic fault schedule (plain data: shrinkable)."""
    faults: Tuple[Fault, ...] = ()

    @staticmethod
    def seeded(seed: int, *, n_namenodes: int, n_faults: int = 1,
               max_at: int = 12,
               sites: Sequence[FaultSite] = tuple(FaultSite),
               kinds: Sequence[str] = (CRASH, PARTITION)) -> "ChaosPlan":
        """Derive a plan from an integer seed — the fixed-seed regression
        twin of the hypothesis strategy (same schedule space)."""
        rng = random.Random(seed)
        faults = []
        for _ in range(n_faults):
            site = rng.choice(list(sites))
            kind = rng.choice([k for k in kinds
                               if k == CRASH
                               or (k == PARTITION and site in PARTITIONABLE)
                               or (k == DELAY
                                   and site is not FaultSite.HEARTBEAT)])
            faults.append(Fault(site=site, at=rng.randrange(max_at + 1),
                                victim=rng.choice(
                                    [None] + list(range(n_namenodes))),
                                kind=kind,
                                heal_after=rng.randrange(1, 5),
                                delay_ticks=(rng.randrange(1, 4)
                                             if kind == DELAY else 2)))
        return ChaosPlan(tuple(faults))


def fault_schedules(*, n_namenodes: int, max_at: int = 16,
                    max_faults: int = 2,
                    sites: Sequence[FaultSite] = tuple(FaultSite),
                    kinds: Sequence[str] = (CRASH, PARTITION)):
    """Hypothesis strategy over :class:`ChaosPlan` (site × trace-index ×
    victim), imported lazily so the module works without hypothesis
    installed (property tests skip; fixed-seed regressions still run)."""
    import hypothesis.strategies as st

    def mk_fault(site: FaultSite, at: int, victim: Optional[int],
                 kind: str, heal_after: int, delay_ticks: int) -> Fault:
        if kind == PARTITION and site not in PARTITIONABLE:
            kind = CRASH
        if kind == DELAY and site is FaultSite.HEARTBEAT:
            kind = CRASH
        return Fault(site=site, at=at, victim=victim, kind=kind,
                     heal_after=heal_after, delay_ticks=delay_ticks)

    fault = st.builds(
        mk_fault,
        site=st.sampled_from(list(sites)),
        at=st.integers(min_value=0, max_value=max_at),
        victim=st.one_of(st.none(),
                         st.integers(min_value=0,
                                     max_value=n_namenodes - 1)),
        kind=st.sampled_from(list(kinds)),
        heal_after=st.integers(min_value=1, max_value=4),
        delay_ticks=st.integers(min_value=1, max_value=3))
    return st.builds(lambda fs: ChaosPlan(tuple(fs)),
                     st.lists(fault, min_size=1, max_size=max_faults))


@dataclass(frozen=True)
class ChaosEvent:
    """One injector decision, for assertions and postmortems."""
    site: FaultSite
    occurrence: int
    nn_id: int
    kind: str
    action: str          # "killed" | "partitioned" | "refused" | "healed"
                         # | "slowed" | "delayed" | "delay-healed"
                         # | "skipped-last-nn"


class FaultInjector:
    """Interprets a :class:`ChaosPlan` against a live cluster.

    Deterministic: per-site occurrence counters (under one lock, so the
    concurrent pipelines count consistently), faults consumed in plan
    order, and a safety rule — a crash that would kill the LAST alive
    namenode is skipped (recorded as ``skipped-last-nn``), so injected
    runs always retain a survivor to converge on.
    """

    def __init__(self, plan: ChaosPlan, cluster: Any):
        self.plan = plan
        self.cluster = cluster
        self.counts: Dict[FaultSite, int] = {s: 0 for s in FaultSite}
        self.pending: List[Fault] = list(plan.faults)
        self.partitioned: Dict[int, int] = {}   # nn_id -> refusals left
        self.slowed: Dict[int, int] = {}        # nn_id -> slow exchanges left
        self.delay_ticks: Dict[int, int] = {}   # nn_id -> ticks per exchange
        self.events: List[ChaosEvent] = []
        self._mu = threading.Lock()
        self._installed = False

    # -- wiring --------------------------------------------------------
    def install(self) -> "FaultInjector":
        """Attach to every injection point of the cluster."""
        for nn in self.cluster.namenodes:
            nn.chaos = self
            nn.subtree.chaos = self
        self.cluster.election.chaos = self
        self._installed = True
        return self

    def uninstall(self) -> None:
        """Detach and heal outstanding partitions (recovery starts)."""
        for nn in self.cluster.namenodes:
            nn.chaos = None
            nn.subtree.chaos = None
        self.cluster.election.chaos = None
        self.partitioned.clear()
        self.slowed.clear()
        self.delay_ticks.clear()
        self._installed = False

    def __enter__(self) -> "FaultInjector":
        return self.install()

    def __exit__(self, et, ev, tb) -> bool:
        self.uninstall()
        return False

    # -- decision core -------------------------------------------------
    def _alive_ids(self) -> List[int]:
        return [nn.nn_id for nn in self.cluster.namenodes if nn.alive]

    def _kill(self, site: FaultSite, n: int, nn_id: int,
              fault: Fault) -> bool:
        alive = self._alive_ids()
        if alive == [nn_id] or nn_id not in alive:
            self.events.append(ChaosEvent(site, n, nn_id, fault.kind,
                                          "skipped-last-nn"))
            return False
        self.cluster.kill(nn_id)
        self.events.append(ChaosEvent(site, n, nn_id, fault.kind,
                                      "killed"))
        return True

    def _match(self, site: FaultSite, n: int, nn_id: int
               ) -> Optional[Fault]:
        for f in self.pending:
            if FaultSite(f.site) is site and n >= f.at \
                    and f.victim in (None, nn_id):
                return f
        return None

    def fire(self, site: str, nn_id: int) -> None:
        """One injection point fired on namenode ``nn_id``.  Raises the
        injected error (StoreError for a crash — tagged ``chaos_crash`` so
        a crashed namenode's cleanup handlers know NOT to run —
        NetworkPartition for a refused exchange) or returns normally.
        A DELAY fault raises nothing: the exchange proceeds, but first
        the shared logical clock advances ``delay_ticks`` — the victim
        is limping, so everyone else's leases, deadlines, and election
        staleness age while it works (gray failure, not clean death)."""
        fsite = FaultSite(site)
        advance = 0
        err: Optional[Exception] = None
        with self._mu:
            n = self.counts[fsite]
            self.counts[fsite] = n + 1
            # an active partition refuses this exchange first
            if fsite in PARTITIONABLE and nn_id in self.partitioned:
                left = self.partitioned[nn_id] - 1
                if left <= 0:
                    del self.partitioned[nn_id]
                    self.events.append(ChaosEvent(fsite, n, nn_id,
                                                  PARTITION, "healed"))
                else:
                    self.partitioned[nn_id] = left
                    self.events.append(ChaosEvent(fsite, n, nn_id,
                                                  PARTITION, "refused"))
                err = NetworkPartition(
                    f"client partitioned from namenode {nn_id}")
            # an active slowdown burns clock on every exchange
            if err is None and nn_id in self.slowed:
                advance = self.delay_ticks.get(nn_id, 1)
                left = self.slowed[nn_id] - 1
                if left <= 0:
                    del self.slowed[nn_id]
                    self.delay_ticks.pop(nn_id, None)
                    self.events.append(ChaosEvent(fsite, n, nn_id,
                                                  DELAY, "delay-healed"))
                else:
                    self.slowed[nn_id] = left
                    self.events.append(ChaosEvent(fsite, n, nn_id,
                                                  DELAY, "delayed"))
            if err is None:
                fault = self._match(fsite, n, nn_id)
                if fault is not None:
                    self.pending.remove(fault)
                    if fault.kind == PARTITION:
                        self.partitioned[nn_id] = fault.heal_after
                        self.events.append(ChaosEvent(fsite, n, nn_id,
                                                      PARTITION,
                                                      "partitioned"))
                        err = NetworkPartition(
                            f"client partitioned from namenode {nn_id}")
                    elif fault.kind == DELAY:
                        self.slowed[nn_id] = fault.heal_after
                        self.delay_ticks[nn_id] = fault.delay_ticks
                        advance += fault.delay_ticks
                        self.events.append(ChaosEvent(fsite, n, nn_id,
                                                      DELAY, "slowed"))
                    elif self._kill(fsite, n, nn_id, fault):
                        e = StoreError(f"chaos: namenode {nn_id} crashed "
                                       f"at {fsite.value}#{n}")
                        e.chaos_crash = True  # crashed NNs run no cleanup
                        err = e
        # clock advancement OUTSIDE the injector lock: tick() heartbeats
        # the fleet, which re-enters allow_heartbeat (and thus _mu)
        if advance:
            self._advance_clock(advance)
        if err is not None:
            raise err

    def _advance_clock(self, ticks: int) -> None:
        """Model the wall-clock time a gray-slow exchange burns: advance
        the SHARED logical clock via full heartbeat rounds, so live
        namenodes stay live (only time passes — nobody is falsely
        declared dead) while leases age and deadlines approach."""
        for _ in range(ticks):
            self.cluster.tick()

    def allow_heartbeat(self, nn_id: int) -> bool:
        """HEARTBEAT-site twin of :meth:`fire`: returning False suppresses
        the liveness proof (the victim just died), instead of raising into
        the cluster's tick loop."""
        with self._mu:
            n = self.counts[FaultSite.HEARTBEAT]
            self.counts[FaultSite.HEARTBEAT] = n + 1
            fault = self._match(FaultSite.HEARTBEAT, n, nn_id)
            if fault is None:
                return True
            self.pending.remove(fault)
            return not self._kill(FaultSite.HEARTBEAT, n, nn_id, fault)

    def heal_all(self) -> None:
        with self._mu:
            self.partitioned.clear()
            self.slowed.clear()
            self.delay_ticks.clear()

    @property
    def injected(self) -> List[ChaosEvent]:
        return [e for e in self.events
                if e.action in ("killed", "partitioned", "slowed")]


# ---------------------------------------------------------------------------
# recovery invariants
# ---------------------------------------------------------------------------


class RecoveryInvariants:
    """The convergence oracle a chaos run must satisfy AFTER recovery.

    Each check returns a list of violation strings (empty = holds), so a
    failing property test shows every broken invariant at once;
    :meth:`assert_all` raises with the full report.
    """

    def __init__(self, store: MetadataStore, cluster: Any = None):
        self.store = store
        self.cluster = cluster

    # -- namespace equality vs the fault-free oracle -------------------
    def namespace_violations(self, oracle_snapshot: Dict[str, tuple]
                             ) -> List[str]:
        from .namenode import namespace_snapshot
        got = namespace_snapshot(self.store)
        out = []
        for path in sorted(set(oracle_snapshot) | set(got)):
            a, b = oracle_snapshot.get(path), got.get(path)
            if a != b:
                out.append(f"namespace diverged at {path}: "
                           f"oracle={a!r} got={b!r}")
        return out

    # -- OpCost conservation -------------------------------------------
    def cost_violations(self, outcome_cost: OpCost,
                        per_nn_delta: Dict[int, OpCost],
                        housekeeping: Optional[OpCost] = None
                        ) -> List[str]:
        """Merging every namenode's committed-cost delta must equal the
        merge of every successful outcome's cost plus the housekeeping
        (lease sweeps) the recovery protocol ran — faults must never
        mint or leak accounted round trips."""
        total = OpCost()
        for c in per_nn_delta.values():
            total.merge(c)
        expect = outcome_cost.copy()
        if housekeeping is not None:
            expect.merge(housekeeping)
        if total.as_dict() != expect.as_dict():
            return [f"OpCost not conserved: per-NN {total.as_dict()} != "
                    f"outcomes+housekeeping {expect.as_dict()}"]
        return []

    # -- orphan rows ----------------------------------------------------
    def orphan_violations(self) -> List[str]:
        out: List[str] = []
        inode_t = self.store.table("inode")
        ids = {r["id"] for r in inode_t.scan_all(lambda r: True)}
        holders = {r["holder"]
                   for r in self.store.table("lease").scan_all(
                       lambda r: True)}
        for lp in self.store.table("lease_path").scan_all(lambda r: True):
            if lp["inode_id"] not in ids:
                out.append(f"orphan lease_path row for deleted inode "
                           f"{lp['inode_id']}")
            if lp["holder"] not in holders:
                out.append(f"orphan lease_path row: holder "
                           f"{lp['holder']!r} has no lease")
        for r in inode_t.scan_all(
                lambda r: not r["is_dir"] and r.get("under_construction")):
            if r.get("client") is None:
                out.append(f"inode {r['id']} under construction with no "
                           f"writer")
            elif r["client"] not in holders:
                out.append(f"orphan under_construction: inode {r['id']} "
                           f"writer {r['client']!r} has no lease")
        for b in self.store.table("block").scan_all(lambda r: True):
            if b["inode_id"] not in ids:
                out.append(f"orphan block {b['block_id']} of deleted "
                           f"inode {b['inode_id']}")
        for r in inode_t.scan_all(
                lambda r: r.get("subtree_lock") is not None):
            out.append(f"stale subtree lock on inode {r['id']} "
                       f"(owner NN {r['subtree_lock']})")
        for r in self.store.table("ongoing_subtree_ops").scan_all(
                lambda r: True):
            out.append(f"stale ongoing_subtree_ops row for inode "
                       f"{r['inode_id']}")
        return out

    # -- lock release ---------------------------------------------------
    def lock_violations(self) -> List[str]:
        held = {txn: keys for txn, keys
                in self.store.locks._held.items() if keys}
        if held:
            return [f"LockManager not fully released: txn {txn} holds "
                    f"{len(keys)} locks" for txn, keys in held.items()]
        return []

    def assert_all(self, oracle_snapshot: Optional[Dict[str, tuple]] = None,
                   *, outcome_cost: Optional[OpCost] = None,
                   per_nn_delta: Optional[Dict[int, OpCost]] = None,
                   housekeeping: Optional[OpCost] = None) -> None:
        out = self.orphan_violations() + self.lock_violations()
        if oracle_snapshot is not None:
            out += self.namespace_violations(oracle_snapshot)
        if outcome_cost is not None and per_nn_delta is not None:
            out += self.cost_violations(outcome_cost, per_nn_delta,
                                        housekeeping)
        assert not out, "recovery invariants violated:\n  " + \
            "\n  ".join(out)


# ---------------------------------------------------------------------------
# chaos replay under recovery
# ---------------------------------------------------------------------------

#: outcome error names the recovery protocol re-drives: transient
#: transport/abort failures, NOT genuine FS outcomes (FileNotFound, ...)
RETRYABLE_ERRORS = frozenset({
    "StoreError", "NetworkPartition", "LockTimeout", "TransactionAborted",
    "SubtreeLockedError",
    # admission sheds (repro_torch.core.admission): the op itself is valid —
    # only its timing budget or a pressure policy refused it, so the
    # recovery protocol re-drives it once the fault/pressure cleared
    # (required for namespace equality when MUTATIONS are shed)
    "DeadlineExpired", "OverloadShed"})


@dataclass
class ChaosReport:
    """What a :func:`replay_with_recovery` run did and cost."""
    outcomes: List[Any]
    ok: int
    failed: int
    recovery_rounds: int
    retried_ops: int
    events: List[ChaosEvent] = field(default_factory=list)
    outcome_cost: OpCost = field(default_factory=OpCost)
    housekeeping_cost: OpCost = field(default_factory=OpCost)
    per_nn_delta: Dict[int, OpCost] = field(default_factory=dict)


def _agg_costs(cluster: Any) -> OpCost:
    total = OpCost()
    for nn in cluster.namenodes:
        total.merge(nn.agg_cost)
    return total


def replay_with_recovery(cluster: Any, wops: Sequence[WorkloadOp], *,
                         injector: Optional[FaultInjector] = None,
                         batch_size: int = 8, planned: bool = False,
                         max_rounds: int = 5) -> ChaosReport:
    """Drive ``wops`` through a pipeline under fault injection, then run
    the §7.6 recovery protocol until outcomes converge:

      1. tick the election past the heartbeat staleness bound, so dead
         namenodes' subtree locks become reclaimable (§6.2) and the
         leader role moves;
      2. run the leader's housekeeping (lease-recovery sweep + orphaned
         lease-path scrub);
      3. re-drive every transiently-failed op, in submission order, on
         the survivors (the client's failover retry, §7.6.1).

    The injector is detached before recovery — faults strike during the
    replay; recovery itself runs fault-free (crashed namenodes STAY
    crashed; recovery must succeed without them)."""
    from .batch_planner import PlannedRequestPipeline
    from .namenode import RequestPipeline
    wops = list(wops)
    cost0 = {nn.nn_id: nn.agg_cost.copy() for nn in cluster.namenodes}
    if injector is not None:
        injector.install()
    try:
        if planned:
            stats = PlannedRequestPipeline(
                cluster, batch_size=batch_size).run(wops)
        else:
            stats = RequestPipeline(cluster, batch_size=batch_size).run(wops)
    finally:
        if injector is not None:
            injector.uninstall()
    outcomes: List[Any] = list(stats.outcomes)
    housekeeping = OpCost()
    rounds = retried = 0
    while rounds < max_rounds:
        todo = [i for i, oc in enumerate(outcomes)
                if not oc.ok and oc.error in RETRYABLE_ERRORS]
        if not todo or not cluster.alive_namenodes():
            break
        rounds += 1
        retried += len(todo)
        # let the election see the deaths (bounded staleness, §7.6);
        # housekeeping cost (lease sweeps — possibly auto, on tick) is
        # measured around the whole non-pipeline recovery step
        before = _agg_costs(cluster)
        for _ in range(cluster.election.max_missed + 1):
            cluster.tick()
        cluster.recover_leases()
        housekeeping.merge(_agg_costs(cluster).diff(before))
        rstats = RequestPipeline(cluster, batch_size=batch_size).run(
            [wops[i] for i in todo])
        for i, oc in zip(todo, rstats.outcomes):
            outcomes[i] = oc
    # final housekeeping: scrub lease_path rows orphaned by deletes (the
    # model's deferred HDFS LeaseManager on-delete cleanup) so the
    # post-recovery store satisfies the zero-orphan invariant
    if cluster.alive_namenodes():
        before = _agg_costs(cluster)
        ldr = cluster.leader()
        if ldr is None or not ldr.alive:
            # a zero-retry run never entered the recovery loop: let the
            # election converge on a live leader before housekeeping
            for _ in range(cluster.election.max_missed + 1):
                cluster.tick()
        cluster.scrub_leases()
        housekeeping.merge(_agg_costs(cluster).diff(before))
    outcome_cost = OpCost()
    ok = failed = 0
    for oc in outcomes:
        if oc.ok:
            ok += 1
            outcome_cost.merge(oc.result.cost)
        else:
            failed += 1
    per_nn = {nn.nn_id: nn.agg_cost.diff(cost0.get(nn.nn_id, OpCost()))
              for nn in cluster.namenodes}
    return ChaosReport(outcomes=outcomes, ok=ok, failed=failed,
                       recovery_rounds=rounds, retried_ops=retried,
                       events=list(injector.events) if injector else [],
                       outcome_cost=outcome_cost,
                       housekeeping_cost=housekeeping,
                       per_nn_delta=per_nn)
