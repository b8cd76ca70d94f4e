"""Elastic namenode pool — load-adaptive scale-out/in over a live cluster.

The paper removes the single-namenode bottleneck by making namenodes
stateless over a shared NewSQL store (§3); this module adds the next step
λFS argues for (PAPERS.md): **elastic** metadata serving, where fleet size
follows offered load instead of being fixed at construction. Because all
durable state lives in the store, membership changes are cheap — the only
thing a namenode "owns" is its warm :class:`~repro_torch.core.hint_cache.
InodeHintCache`, and that is exactly what the pool migrates.

Control loop
------------
:class:`ElasticNamenodePool` wraps a :class:`~repro_torch.core.namenode.
NamenodeCluster` and is ticked on the election's logical clock (each
:meth:`tick` is one heartbeat round). Every tick it samples fleet load:

* ``ops_delta`` — ops served fleet-wide since the last tick
  (``Namenode.ops_served`` deltas),
* ``queue_depth`` — the caller-reported backlog (the planned pipeline
  passes its remaining-trace depth),
* ``lock_wait_frac`` — store-level lock contention
  (``LockManager.wait_count`` / ``acquire_count`` deltas).

Per-namenode load is ``(ops_delta + queue_depth) / alive``. The policy is
deliberately boring — watermarks with hysteresis and a cooldown:

* ``hysteresis`` consecutive samples above ``high_load`` → scale OUT
  (up to ``max_namenodes``),
* ``hysteresis`` consecutive samples below ``low_load`` → scale IN
  (down to ``min_namenodes``),
* at most one scale action per ``cooldown`` ticks, so the fleet cannot
  thrash on a load spike that the previous action already absorbed.

Warm migration
--------------
Scale-out: the joiner is built by ``NamenodeCluster.add_namenode`` and
**pre-warmed before it is ever dealt a batch** — every client cache
registered via :meth:`register_client_cache` exports its newest
``prewarm_limit`` entries (:meth:`InodeHintCache.export_entries`) and the
joiner absorbs them. A cold joiner would answer its first windows with
recursive resolves; a pre-warmed one starts near the fleet's steady-state
hint hit rate (the ``elasticity`` bench section measures exactly this).

Scale-in: retirement is planned, not a crash. The victim (highest-id
alive non-leader) first exports its warm working set to every survivor,
then ``NamenodeCluster.retire`` drops it from the election *immediately*
(no staleness bound — contrast §7.6 failure detection). The leader then
reclaims any leases the victim's clients held via the existing
``recover_leases``/``scrub_leases`` housekeeping, so in-flight leases
survive membership changes without client involvement.

Every action bumps :attr:`membership_epoch` and notifies subscribers —
the ``membership_refresh`` middleware uses this to rebalance
``DFSClient`` selectors without dropping in-flight calls.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional

from .hint_cache import InodeHintCache
from .namenode import Namenode, NamenodeCluster


@dataclass
class LoadSample:
    """One tick's fleet telemetry (sampled on the election clock)."""
    t: int                  # election logical clock at sampling
    alive: int              # fleet size when sampled
    ops_delta: int          # ops served since the previous sample
    queue_depth: int        # caller-reported backlog (0 if not driven)
    lock_wait_frac: float   # store lock-wait fraction over the interval
    load: float             # (ops_delta + queue_depth) / alive


@dataclass
class ScaleEvent:
    """One membership change the pool performed."""
    t: int                  # election logical clock of the action
    action: str             # "scale_out" | "scale_in"
    nn_id: int              # joiner / victim namenode id
    reason: str             # human-readable trigger description
    migrated_entries: int = 0   # hint entries moved (pre-warm or migrate)


class ElasticNamenodePool:
    """Load-adaptive controller over a :class:`NamenodeCluster`.

    The pool never touches durable metadata — it only changes WHO serves
    (membership) and keeps hint caches warm across those changes. All
    decisions happen inside :meth:`tick`; nothing is threaded or timed,
    so replays with a pool attached stay deterministic.
    """

    def __init__(self, cluster: NamenodeCluster, *,
                 min_namenodes: int = 1,
                 max_namenodes: int = 8,
                 high_load: float = 128.0,
                 low_load: float = 16.0,
                 hysteresis: int = 2,
                 cooldown: int = 2,
                 prewarm_limit: int = 4096,
                 breakers: Any = None):
        if min_namenodes < 1:
            raise ValueError("min_namenodes must be >= 1")
        if low_load >= high_load:
            raise ValueError("low_load must be < high_load")
        self.cluster = cluster
        #: optional admission.BreakerBoard — scale-in prefers retiring a
        #: namenode whose breaker is OPEN (the fleet sheds its gray-slow
        #: member first instead of a healthy late joiner)
        self.breakers = breakers
        self.min_namenodes = min_namenodes
        self.max_namenodes = max_namenodes
        self.high_load = high_load
        self.low_load = low_load
        self.hysteresis = max(1, hysteresis)
        self.cooldown = max(0, cooldown)
        self.prewarm_limit = prewarm_limit

        #: bumped on every membership change; clients compare against it
        #: (``membership_refresh`` middleware) to rebalance lazily
        self.membership_epoch = 0
        self.samples: List[LoadSample] = []
        self.events: List[ScaleEvent] = []
        self.scale_outs = 0
        self.scale_ins = 0
        self.migrated_entries = 0

        self._subscribers: List[Callable[[ScaleEvent], None]] = []
        self._client_caches: List[InodeHintCache] = []
        self._high_streak = 0
        self._low_streak = 0
        self._last_action_t: Optional[int] = None
        self._last_ops_total = self._ops_total()
        locks = cluster.store.locks
        self._last_waits = locks.wait_count
        self._last_acquires = locks.acquire_count

    # -- wiring ---------------------------------------------------------
    def subscribe(self, fn: Callable[[ScaleEvent], None]) -> None:
        """Call ``fn(event)`` after every membership change."""
        self._subscribers.append(fn)

    def register_client_cache(self, cache: InodeHintCache) -> None:
        """Make a client-side hint cache a pre-warm donor for joiners."""
        if cache not in self._client_caches:
            self._client_caches.append(cache)

    # -- telemetry ------------------------------------------------------
    def _ops_total(self) -> int:
        return sum(nn.ops_served for nn in self.cluster.namenodes)

    def _sample(self, queue_depth: int) -> LoadSample:
        total = self._ops_total()
        ops_delta = total - self._last_ops_total
        self._last_ops_total = total
        locks = self.cluster.store.locks
        dw = locks.wait_count - self._last_waits
        da = locks.acquire_count - self._last_acquires
        self._last_waits = locks.wait_count
        self._last_acquires = locks.acquire_count
        alive = len(self.cluster.alive_namenodes())
        s = LoadSample(t=self.cluster.election.now,
                       alive=max(1, alive),
                       ops_delta=ops_delta,
                       queue_depth=queue_depth,
                       lock_wait_frac=(dw / da if da else 0.0),
                       load=(ops_delta + queue_depth) / max(1, alive))
        self.samples.append(s)
        return s

    # -- control loop ---------------------------------------------------
    def tick(self, *, queue_depth: int = 0) -> Optional[ScaleEvent]:
        """One control round: heartbeat the fleet, sample load, and act
        if the watermark/hysteresis/cooldown policy says so. Returns the
        :class:`ScaleEvent` performed this tick, if any."""
        self.cluster.tick()
        s = self._sample(queue_depth)
        if s.load > self.high_load:
            self._high_streak += 1
            self._low_streak = 0
        elif s.load < self.low_load:
            self._low_streak += 1
            self._high_streak = 0
        else:
            self._high_streak = 0
            self._low_streak = 0
        if not self._cooled(s.t):
            return None
        alive = len(self.cluster.alive_namenodes())
        if self._high_streak >= self.hysteresis \
                and alive < self.max_namenodes:
            return self.scale_out(
                f"load {s.load:.1f} > {self.high_load:.1f} for "
                f"{self._high_streak} ticks")
        if self._low_streak >= self.hysteresis \
                and alive > self.min_namenodes:
            return self.scale_in(
                f"load {s.load:.1f} < {self.low_load:.1f} for "
                f"{self._low_streak} ticks")
        return None

    def _cooled(self, now: int) -> bool:
        return (self._last_action_t is None
                or now - self._last_action_t >= self.cooldown)

    # -- actions --------------------------------------------------------
    def scale_out(self, reason: str = "manual") -> ScaleEvent:
        """Add one namenode, pre-warmed from the registered client caches
        BEFORE it can be dealt traffic (callers pick up the new member on
        their next ``alive_namenodes()`` read, which is after this
        returns)."""
        nn = self.cluster.add_namenode()
        moved = 0
        if nn.ops.cache is not None:
            for cache in self._client_caches:
                entries = cache.export_entries(self.prewarm_limit)
                nn.ops.cache.absorb(entries)
                moved += len(entries)
        return self._record("scale_out", nn.nn_id, reason, moved)

    def scale_in(self, reason: str = "manual") -> Optional[ScaleEvent]:
        """Retire one namenode: warm-migrate its hint cache to every
        survivor, drop it from the election (immediate — retirement is
        planned), and run the leader's lease housekeeping so any lease
        the victim's clients held is reclaimed, not leaked."""
        victim = self._pick_victim()
        if victim is None:
            return None
        moved = 0
        survivors = [nn for nn in self.cluster.alive_namenodes()
                     if nn.nn_id != victim.nn_id]
        if victim.ops.cache is not None:
            entries = victim.ops.cache.export_entries(self.prewarm_limit)
            for nn in survivors:
                if nn.ops.cache is not None:
                    nn.ops.cache.absorb(entries)
                    moved += len(entries)
        self.cluster.retire(victim.nn_id)
        self.cluster.recover_leases()
        self.cluster.scrub_leases()
        return self._record("scale_in", victim.nn_id, reason, moved)

    def _pick_victim(self) -> Optional[Namenode]:
        """Highest-id alive non-leader — late joiners retire first, and
        the leader never retires itself (its housekeeping must run the
        same tick to reclaim the victim's leases). With a breaker board
        attached, an OPEN-breaker namenode is preferred: shrinking the
        fleet should shed its gray-slow member, not a healthy one."""
        leader = self.cluster.election.leader()
        cands = [nn for nn in self.cluster.alive_namenodes()
                 if nn.nn_id != leader]
        if not cands:
            return None
        if self.breakers is not None:
            tripped = [nn for nn in cands
                       if self.breakers.is_open(nn.nn_id)]
            if tripped:
                return max(tripped, key=lambda nn: nn.nn_id)
        return max(cands, key=lambda nn: nn.nn_id)

    def _record(self, action: str, nn_id: int, reason: str,
                moved: int) -> ScaleEvent:
        ev = ScaleEvent(t=self.cluster.election.now, action=action,
                        nn_id=nn_id, reason=reason, migrated_entries=moved)
        self.events.append(ev)
        self.migrated_entries += moved
        if action == "scale_out":
            self.scale_outs += 1
        else:
            self.scale_ins += 1
        self.membership_epoch += 1
        self._last_action_t = ev.t
        self._high_streak = 0
        self._low_streak = 0
        for fn in self._subscribers:
            fn(ev)
        return ev
