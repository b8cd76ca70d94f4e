"""Overload-hardened request path: deadlines, fair-queue admission,
retry budgets, and circuit breakers.

The paper's latency claims (§7.3) and its no-downtime failover story
(§7.6) both assume namenodes that are either healthy or *dead*. Real
fleets also fail **gray** — a namenode that is alive, heartbeating, and
10x slower than its peers — and under a Zipfian client population
(arXiv:2005.06963's hot-spot taxonomy) naive bounded retry loops turn
one slow server into a metastable overload: every retry adds load,
every added load slows the server further. This module is the
protection layer:

Deadline propagation
    Every :class:`~repro_torch.core.ops_registry.WorkloadOp` may carry a
    ``deadline`` on the election's logical clock (the one clock
    namenode liveness, lease liveness, and now request staleness all
    share). A namenode **sheds** work whose deadline already passed
    (:class:`DeadlineExpired`) instead of executing it — executing an
    op nobody is waiting for is pure amplification — and the planned
    pipeline deals only ops that can still make their deadline
    (``BatchPlanner.plan_window``). :func:`stamp_deadlines` tags a
    trace; goodput is then ``ok and completed_at <= deadline``
    (``OpResult.completed_at`` is stamped by the namenode RPC layer).

Weighted fair queueing + load shedding
    :class:`AdmissionController` sits at namenode admission
    (``Namenode.execute_batch`` / ``invoke``). Under queue pressure
    (:meth:`AdmissionController.observe_queue`) it sheds
    (:class:`OverloadShed`) in strict priority order: **reads from hot
    tenants first, lease-holding mutations never** — a shed read is a
    wasted round trip, but a shed mutation under lease risks losing a
    writer's progress. "Hot" is decided by per-tenant virtual time
    (classic WFQ): each admitted op advances its tenant's vtime by
    cost/weight, and tenants above their fair share shed first, so a
    Zipf s≈1.1 tenant mix cannot starve cold tenants. Per-client and
    per-partition telemetry (:meth:`AdmissionController.report`) feeds
    the bench's ``overload`` section.

Retry budgets
    :class:`RetryBudget` is a token bucket shared by EVERY retrying
    middleware on a client (``failover``/``txn_retry``/
    ``subtree_retry``): each logical call deposits ``refill_rate``
    tokens (:meth:`~RetryBudget.note_call`), each retry spends one
    (:meth:`~RetryBudget.try_spend`). The fleet-wide retry rate is
    thus bounded at ~``refill_rate`` of the call rate no matter how
    the per-middleware attempt counters multiply — the standard
    defence against retry storms.

Circuit breakers
    :class:`CircuitBreaker` per namenode (closed → open → half-open
    probes), aggregated in a :class:`BreakerBoard`. Transport-class
    failures (:data:`BREAKER_FAILURES`) trip the breaker; genuine FS
    outcomes (FileNotFound, quota, lease conflicts) never do. The
    board integrates with routing: ``BatchPlanner`` stops dealing free
    chunks to open namenodes, ``Client._pick`` avoids them, and
    ``ElasticNamenodePool`` prefers retiring a tripped namenode.

Everything runs on the deterministic logical clock — no wall-clock
reads — so chaos replays (``DELAY`` faults, docs/CHAOS.md) reproduce
bit-for-bit. See docs/ROBUSTNESS.md for the policy rationale.
"""
from __future__ import annotations

import threading
import zlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

from .fs import FSError
from .middleware import CallContext, Handler, Middleware
from .ops_registry import REGISTRY, WorkloadOp


class DeadlineExpired(FSError):
    """The op's deadline passed before a namenode could execute it: shed,
    not failed — the client already stopped waiting, so executing would
    only amplify overload. Retryable by the chaos recovery protocol
    (the op itself is valid; only its timing budget ran out)."""


class OverloadShed(FSError):
    """The admission controller refused the op under queue pressure
    (WFQ policy: hot-tenant reads first). Retryable — the op is valid
    and will be admitted once pressure clears."""


#: outcome error names that count as TRANSPORT failures for circuit
#: breaking — a server producing these is sick or unreachable. Genuine
#: FS outcomes (FileNotFound, LeaseConflict, quota...) never trip a
#: breaker: they are proof the server is working.
BREAKER_FAILURES = frozenset({
    "StoreError", "NetworkPartition", "LockTimeout", "TransactionAborted",
    "DeadlineExpired",
})


def stamp_deadlines(wops: Sequence[WorkloadOp], *, now: int, budget: int,
                    per_op: float = 0.0) -> Sequence[WorkloadOp]:
    """Tag every op with ``deadline = now + budget (+ i*per_op)`` on the
    election clock. ``per_op`` staggers deadlines for very long traces
    where later ops are naturally submitted later. Mutates in place
    (traces are built fresh) and returns ``wops`` for chaining."""
    for i, wop in enumerate(wops):
        wop.deadline = now + budget + int(i * per_op)
    return wops


def _is_lease_mutation(spec: Any) -> bool:
    """Lease-holding mutations — ops that carry or renew a client lease
    (create/append/add_block/...) — are never pressure-shed: shedding
    them stalls a writer mid-file and risks soft-limit takeover of its
    lease. They can still be deadline-shed (nobody is waiting)."""
    return spec is not None and not spec.read_only and (
        spec.has_client_arg or spec.renews_lease
        or spec.lease_order is not None)


@dataclass
class TenantLoad:
    """Per-tenant WFQ accounting + telemetry."""
    admitted: int = 0
    shed: int = 0
    vtime: float = 0.0      # virtual time: Σ cost/weight of admitted ops

    @property
    def offered(self) -> int:
        return self.admitted + self.shed


class AdmissionController:
    """Namenode-side admission: deadline shedding always, WFQ load
    shedding under queue pressure.

    Installed on every namenode of a cluster (:meth:`install`, the
    ``FaultInjector.install`` pattern); ``Namenode.execute_batch`` asks
    :meth:`admit_batch` before executing, ``Namenode.invoke`` asks
    :meth:`check_op` on the sequential path. The driving pipeline
    reports its backlog each window via :meth:`observe_queue`; pressure
    is ``queue_depth > queue_capacity``.

    Shed ordering under pressure (strict priority, docs/ROBUSTNESS.md):

    1. any op past its deadline (always shed, pressure or not),
    2. reads from tenants above fair share (largest vtime first),
    3. non-lease mutations from over-share tenants, only under severe
       pressure (queue > ``severe_factor`` x capacity),
    4. lease-holding mutations: never pressure-shed.

    A tenant at or below its fair share of admitted work is never
    pressure-shed, so cold tenants cannot be starved by a hot one.
    """

    def __init__(self, election: Any, *, queue_capacity: int = 256,
                 severe_factor: float = 2.0, n_partitions: int = 8,
                 weights: Optional[Dict[str, float]] = None):
        self.election = election
        self.queue_capacity = queue_capacity
        self.severe_factor = severe_factor
        self.n_partitions = max(1, n_partitions)
        self.weights = dict(weights or {})
        self.queue_depth = 0
        self.tenants: Dict[str, TenantLoad] = {}
        self.clients: Dict[str, int] = {}       # per-client admitted ops
        self.partition_load: Dict[int, int] = {}  # partition -> admitted
        self.admitted = 0
        self.shed_deadline = 0
        self.shed_pressure = 0
        self._mu = threading.Lock()
        self._installed: List[Any] = []

    # -- wiring ---------------------------------------------------------
    def install(self, cluster: Any) -> "AdmissionController":
        """Attach to every namenode of ``cluster`` (late joiners are NOT
        auto-attached — the pool's `add_namenode` copies chaos hooks,
        admission is per-experiment wiring)."""
        self.n_partitions = cluster.store.n_partitions
        for nn in cluster.namenodes:
            nn.admission = self
            self._installed.append(nn)
        return self

    def uninstall(self) -> None:
        for nn in self._installed:
            nn.admission = None
        self._installed.clear()

    def observe_queue(self, depth: int) -> None:
        """Pipeline backlog report — the pressure signal."""
        self.queue_depth = max(0, depth)

    # -- policy ---------------------------------------------------------
    def _weight(self, tenant: str) -> float:
        return self.weights.get(tenant, 1.0)

    def _fair_share(self) -> float:
        """Equal-weight fair share of admitted work per tenant."""
        n = max(1, len(self.tenants))
        return max(1.0, self.admitted / n)

    def _over_share(self, tenant: str) -> bool:
        load = self.tenants.get(tenant)
        if load is None:
            return False
        return load.admitted > self._fair_share()

    def _account(self, wop: WorkloadOp, spec: Any, shed: Optional[str]
                 ) -> None:
        tenant = wop.tenant or "-"
        t = self.tenants.setdefault(tenant, TenantLoad())
        if shed is not None:
            t.shed += 1
            return
        t.admitted += 1
        cost = 1.0 if (spec is not None and spec.read_only) else 2.0
        t.vtime += cost / self._weight(tenant)
        self.admitted += 1
        client = str((wop.args or {}).get("client", "client"))
        self.clients[client] = self.clients.get(client, 0) + 1
        part = zlib.crc32(wop.path.encode()) % self.n_partitions
        self.partition_load[part] = self.partition_load.get(part, 0) + 1

    def check_op(self, wop: WorkloadOp, *, record: bool = True
                 ) -> None:
        """Sequential-path admission (``Namenode.invoke``): deadline
        shedding only — a single RPC carries no queue to fair-share.
        Raises :class:`DeadlineExpired`; ``record=False`` re-checks an
        already-admitted op (mid-batch) without double-counting."""
        spec = REGISTRY.get(wop.op)
        if wop.deadline is not None and self.election.now > wop.deadline:
            with self._mu:
                self.shed_deadline += 1
                if record:
                    self._account(wop, spec, "DeadlineExpired")
            raise DeadlineExpired(
                f"{wop.op} {wop.path}: deadline {wop.deadline} < "
                f"now {self.election.now}")
        if record:
            with self._mu:
                self._account(wop, spec, None)

    def admit_batch(self, wops: Sequence[WorkloadOp]
                    ) -> List[Optional[str]]:
        """Batch admission: one decision per op — None (admit) or the
        shed error name. Deadline sheds are unconditional; pressure
        sheds follow the WFQ priority order documented on the class."""
        now = self.election.now
        pressure = self.queue_depth > self.queue_capacity
        severe = self.queue_depth > self.severe_factor * self.queue_capacity
        # overload fraction decides how much of the batch we may shed
        max_shed = 0
        if pressure and self.queue_depth > 0:
            frac = min(0.9, (self.queue_depth - self.queue_capacity)
                       / self.queue_depth)
            max_shed = int(frac * len(wops))
        decisions: List[Optional[str]] = [None] * len(wops)
        with self._mu:
            sheddable: List[Any] = []   # (priority, vtime, idx)
            for i, wop in enumerate(wops):
                spec = REGISTRY.get(wop.op)
                if wop.deadline is not None and now > wop.deadline:
                    decisions[i] = "DeadlineExpired"
                    self.shed_deadline += 1
                    self._account(wop, spec, "DeadlineExpired")
                    continue
                if pressure and self._over_share(wop.tenant or "-") \
                        and not _is_lease_mutation(spec):
                    read = spec is not None and spec.read_only
                    if read or severe:
                        load = self.tenants.get(wop.tenant or "-")
                        sheddable.append(
                            (0 if read else 1,
                             -(load.vtime if load else 0.0), i))
            # reads before mutations, hottest tenant (largest vtime) first
            sheddable.sort()
            for _, _, i in sheddable[:max_shed]:
                decisions[i] = "OverloadShed"
                self.shed_pressure += 1
                self._account(wops[i], REGISTRY.get(wops[i].op),
                              "OverloadShed")
            for i, wop in enumerate(wops):
                if decisions[i] is None:
                    self._account(wop, REGISTRY.get(wop.op), None)
        return decisions

    # -- telemetry ------------------------------------------------------
    def report(self) -> Dict[str, Any]:
        with self._mu:
            hot = sorted(self.partition_load.items(),
                         key=lambda kv: -kv[1])[:4]
            return {
                "admitted": self.admitted,
                "shed_deadline": self.shed_deadline,
                "shed_pressure": self.shed_pressure,
                "tenants": {
                    t: {"admitted": v.admitted, "shed": v.shed,
                        "vtime": round(v.vtime, 3)}
                    for t, v in sorted(self.tenants.items())},
                "clients": dict(sorted(self.clients.items())),
                "hot_partitions": [list(kv) for kv in hot],
            }


class RetryBudget:
    """Shared token-bucket retry budget (docs/ROBUSTNESS.md math):
    every logical call deposits ``refill_rate`` tokens (capped at
    ``capacity``), every retry — across ALL middleware sharing the
    bucket — spends one. Steady-state retry rate is therefore at most
    ``refill_rate`` x call rate (~10% with the default), which is what
    keeps bounded-attempt retry loops from amplifying a slow namenode
    into a metastable overload. ``capacity`` is the burst allowance."""

    def __init__(self, capacity: float = 20.0, refill_rate: float = 0.1):
        self.capacity = float(capacity)
        self.refill_rate = float(refill_rate)
        self.tokens = float(capacity)
        self.calls = 0
        self.spent = 0
        self.denied = 0
        self._mu = threading.Lock()

    def note_call(self) -> None:
        """One logical call = one deposit (clients call this per op)."""
        with self._mu:
            self.calls += 1
            self.tokens = min(self.capacity, self.tokens + self.refill_rate)

    def try_spend(self) -> bool:
        """Spend one token for a retry; False = budget exhausted, the
        caller must surface its error instead of retrying."""
        with self._mu:
            if self.tokens >= 1.0:
                self.tokens -= 1.0
                self.spent += 1
                return True
            self.denied += 1
            return False


class CircuitBreaker:
    """Per-namenode breaker on the election clock: ``failure_threshold``
    consecutive transport failures open it; after ``reset_after`` ticks
    it half-opens and admits ``half_open_probes`` probe routings; a
    probe success closes it, a probe failure re-opens (fresh timer)."""

    def __init__(self, *, failure_threshold: int = 3, reset_after: int = 8,
                 half_open_probes: int = 1, now: Any = None):
        self.failure_threshold = max(1, failure_threshold)
        self.reset_after = max(1, reset_after)
        self.half_open_probes = max(1, half_open_probes)
        self._now = now or (lambda: 0)
        self.state = "closed"
        self.failures = 0
        self.opened_at: Optional[int] = None
        self.probes_left = 0
        self.trips = 0

    def _maybe_half_open(self) -> None:
        if self.state == "open" and self.opened_at is not None \
                and self._now() - self.opened_at >= self.reset_after:
            self.state = "half_open"
            self.probes_left = self.half_open_probes

    def routable(self) -> bool:
        """May this namenode be dealt work right now? Non-consuming in
        ``closed``; in ``half_open`` each True consumes one probe slot
        (the router sends exactly that much traffic at a sick server)."""
        self._maybe_half_open()
        if self.state == "closed":
            return True
        if self.state == "half_open" and self.probes_left > 0:
            self.probes_left -= 1
            return True
        return False

    @property
    def is_open(self) -> bool:
        """Non-consuming peek (victim selection, telemetry)."""
        self._maybe_half_open()
        return self.state == "open"

    def record_success(self) -> None:
        self.state = "closed"
        self.failures = 0
        self.opened_at = None
        self.probes_left = 0

    def record_failure(self) -> None:
        self.failures += 1
        if self.state == "half_open" \
                or self.failures >= self.failure_threshold:
            if self.state != "open":
                self.trips += 1
            self.state = "open"
            self.opened_at = self._now()
            self.probes_left = 0


class BreakerBoard:
    """One :class:`CircuitBreaker` per namenode id, lazily created on
    the shared election clock. The single integration point for the
    planner (free-chunk slots), the client selector, and the pool."""

    def __init__(self, election: Any, *, failure_threshold: int = 3,
                 reset_after: int = 8, half_open_probes: int = 1):
        self.election = election
        self._kw = dict(failure_threshold=failure_threshold,
                        reset_after=reset_after,
                        half_open_probes=half_open_probes)
        self.breakers: Dict[int, CircuitBreaker] = {}

    def for_nn(self, nn_id: int) -> CircuitBreaker:
        br = self.breakers.get(nn_id)
        if br is None:
            br = CircuitBreaker(now=lambda: self.election.now, **self._kw)
            self.breakers[nn_id] = br
        return br

    def routable(self, nn_id: int) -> bool:
        return self.for_nn(nn_id).routable()

    def is_open(self, nn_id: int) -> bool:
        return self.for_nn(nn_id).is_open

    def record(self, nn_id: int, *, ok: bool) -> None:
        br = self.for_nn(nn_id)
        br.record_success() if ok else br.record_failure()

    @property
    def trips(self) -> int:
        return sum(br.trips for br in self.breakers.values())

    def open_ids(self) -> List[int]:
        return sorted(i for i, br in self.breakers.items() if br.is_open)

    def states(self) -> Dict[int, str]:
        return {i: br.state for i, br in sorted(self.breakers.items())}


def circuit_breaker(board: BreakerBoard) -> Middleware:
    """Middleware recording per-attempt outcomes on the board: placed
    INSIDE ``failover`` so every attempt (not just the logical call)
    updates the breaker of the namenode that served it. Transport-class
    errors (:data:`BREAKER_FAILURES`) count as failures; genuine FS
    outcomes and successes close the breaker."""
    def mw(nxt: Handler) -> Handler:
        def handler(ctx: CallContext) -> Any:
            try:
                res = nxt(ctx)
            except Exception as e:
                nn = ctx.namenode
                if nn is not None:
                    board.record(nn.nn_id,
                                 ok=type(e).__name__ not in BREAKER_FAILURES)
                raise
            nn = ctx.namenode
            if nn is not None:
                board.record(nn.nn_id, ok=True)
            return res
        return handler
    return mw
