"""Discrete-event simulation of HopsFS and HDFS clusters (paper §7).

One CPU container cannot measure 60-namenode wall-clock throughput, so the
cluster-scale experiments (Figs 6, 8, 9, 10, 11) run on a DES whose per-op
**database round-trip profiles are measured from the functional store**
(``profile_op``), not hand-waved: the functional layer executes the op and
its OpCost (how many PK/batch/PPIS/IS round trips, how many were local to
the transaction coordinator) parameterizes the simulated service times.

Modelled resources
  * namenode handler pool (dfs.namenode.handler.count=100, §7.1) — an op
    holds a handler for its full duration, so DB latency limits NN
    concurrency exactly as in the real system;
  * namenode CPU cores (c3.8xlarge: 32 vcores);
  * NDB datanodes — each round trip queues on one database server; local
    round trips (DAT) are cheaper than remote ones; IS/FTS fan out to all
    nodes (Fig 2a cost hierarchy);
  * for HDFS: the single global namespace RW-lock (single writer) + the
    active namenode's handler pool/CPU; failover downtime per §7.6.1.

Calibration constants approximate the paper's AWS c3.8xlarge testbed; the
benchmark suite checks *relative* claims (scaling shape, 2.6x, crossover,
zero-downtime), not absolute microseconds.
"""
from __future__ import annotations

import heapq
import random
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from .fs import HopsFSOps
from .ops_registry import REGISTRY
from .store import MetadataStore, OpCost
from .workload import SpotifyWorkload, WorkloadOp

# ---------------------------------------------------------------------------
# calibration constants (seconds) — AWS c3.8xlarge-ish, virtualized network
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SimParams:
    client_nn_rtt: float = 1.0e-3       # client <-> namenode RPC round trip
    nn_cpu_per_op: float = 28e-6        # namenode CPU per metadata op
    nn_handlers: int = 100              # dfs.namenode.handler.count
    nn_cores: int = 32
    db_rtt_local: float = 0.40e-3       # DAL <-> coordinator-local NDB node
    db_rtt_remote: float = 0.62e-3      # DAL <-> remote NDB node group
    # NDB datanodes run 30 worker threads (§7.1); each round trip occupies
    # one thread for the service time below (Fig 2a cost hierarchy)
    ndb_threads: int = 30
    svc_pk: float = 30e-6
    svc_batch: float = 50e-6
    svc_ppis: float = 90e-6
    svc_is_per_node: float = 120e-6     # IS occupies EVERY NDB node
    svc_fts_per_node: float = 500e-6
    ndb_txn_timeout: float = 1.2        # §7.5
    # HDFS
    hdfs_cpu_read: float = 22e-6
    hdfs_cpu_write: float = 70e-6
    hdfs_lock_write_hold: float = 55e-6  # exclusive namespace lock hold
    hdfs_lock_read_hold: float = 9e-6    # shared-path overhead
    failover_detect: float = 2.0
    failover_replay: float = 7.0         # small-metadata test: 8-10 s total


DEFAULT_PARAMS = SimParams()


# ---------------------------------------------------------------------------
# tiny DES core
# ---------------------------------------------------------------------------


class Sim:
    def __init__(self) -> None:
        self.t = 0.0
        self._q: List[Tuple[float, int, Callable[[], None]]] = []
        self._seq = 0

    def after(self, dt: float, fn: Callable[[], None]) -> None:
        self._seq += 1
        heapq.heappush(self._q, (self.t + dt, self._seq, fn))

    def run(self, until: float) -> None:
        while self._q and self._q[0][0] <= until:
            self.t, _, fn = heapq.heappop(self._q)
            fn()
        self.t = until


class Server:
    """k-server FIFO resource.

    ``submit(hold, done)``  — hold a server for `hold` s, then auto-release.
    ``acquire(granted)``    — grant a server to the caller (who must call
                              ``release()`` when finished); used for
                              resources held across nested waits, e.g. the
                              namenode handler held for the whole op.
    """

    def __init__(self, sim: Sim, k: int):
        self.sim, self.k = sim, k
        self.busy = 0
        self.q: deque = deque()

    # -- held-resource protocol -------------------------------------
    def acquire(self, granted: Callable[[], None]) -> None:
        if self.busy < self.k:
            self.busy += 1
            granted()
        else:
            self.q.append(("acq", granted))

    def release(self) -> None:
        if self.q:
            kind, fn = self.q.popleft()
            if kind == "acq":
                fn()
            else:
                hold, done = fn
                self._hold(hold, done)
        else:
            self.busy -= 1

    # -- auto-release protocol ---------------------------------------
    def submit(self, hold: float, done: Callable[[], None]) -> None:
        if self.busy < self.k:
            self.busy += 1
            self._hold(hold, done)
        else:
            self.q.append(("sub", (hold, done)))

    def _hold(self, hold: float, done: Callable[[], None]) -> None:
        def fin():
            done()
            self.release()
        self.sim.after(hold, fin)


class RWLock:
    """DES readers-writer lock (writer-preferring) — the HDFS global
    namespace lock (§2.1)."""

    def __init__(self, sim: Sim):
        self.sim = sim
        self.readers = 0
        self.writer = False
        self.wq: deque = deque()   # (is_write, hold, done)

    def submit(self, is_write: bool, hold: float,
               done: Callable[[], None]) -> None:
        self.wq.append((is_write, hold, done))
        self._pump()

    def _pump(self) -> None:
        while self.wq:
            is_write, hold, done = self.wq[0]
            if is_write:
                if self.writer or self.readers:
                    return
                self.wq.popleft()
                self.writer = True

                def fin_w(d=done):
                    self.writer = False
                    d()
                    self._pump()
                self.sim.after(hold, fin_w)
            else:
                if self.writer:
                    return
                self.wq.popleft()
                self.readers += 1

                def fin_r(d=done):
                    self.readers -= 1
                    d()
                    self._pump()
                self.sim.after(hold, fin_r)


# ---------------------------------------------------------------------------
# round-trip profiles measured from the functional store
# ---------------------------------------------------------------------------


@dataclass
class RTProfile:
    """Sequence-free summary of one op's DB work."""
    pk: int = 0
    batch: int = 0
    ppis: int = 0
    is_scans: int = 0
    fts: int = 0
    local: int = 0
    remote: int = 0

    @classmethod
    def from_cost(cls, c: OpCost) -> "RTProfile":
        return cls(pk=c.pk_rc + c.pk_r + c.pk_w, batch=c.batches,
                   ppis=c.ppis, is_scans=c.is_scans, fts=c.fts,
                   local=c.local_rt, remote=c.remote_rt)

    def round_trips(self) -> int:
        return self.pk + self.batch + self.ppis + self.is_scans + self.fts


def profile_ops(*, use_cache: bool = True, distribution_aware: bool = True,
                adp: bool = True, depth: int = 7, device: Any = None
                ) -> Dict[str, RTProfile]:
    """Execute each Table-1 op once on a small functional deployment and
    capture its measured cost profile for the DES.  ``device`` is the
    store's (the card unless ``device="cpu"``); the DES itself is host
    Python."""
    store = MetadataStore(n_datanodes=4, device=device)
    from .fs import format_fs
    format_fs(store)
    ops = HopsFSOps(store, 0, use_cache=use_cache,
                    distribution_aware=distribution_aware, adp=adp)
    d = "/" + "/".join(f"l{i}" for i in range(depth - 1))
    ops.mkdirs(d)
    f = d + "/data.bin"
    ops.create(f)
    bid = ops.add_block(f).value
    ops.complete_block(f, bid, size=1 << 27)
    # warm the cache, then measure steady-state profiles
    ops.get_block_locations(f)
    prof: Dict[str, RTProfile] = {}
    prof["read"] = RTProfile.from_cost(ops.get_block_locations(f).cost)
    prof["stat"] = RTProfile.from_cost(ops.stat(f).cost)
    prof["ls"] = RTProfile.from_cost(ops.listing(d).cost)
    prof["content_summary"] = RTProfile.from_cost(
        ops.content_summary(d).cost)
    prof["create"] = RTProfile.from_cost(ops.create(f + ".new").cost)
    prof["add_block"] = RTProfile.from_cost(ops.add_block(f + ".new").cost)
    prof["append"] = RTProfile.from_cost(ops.append_file(f).cost)
    prof["chmod_file"] = RTProfile.from_cost(ops.chmod_file(f, 0o644).cost)
    prof["chown_file"] = RTProfile.from_cost(ops.chown_file(f, "u").cost)
    prof["set_replication"] = RTProfile.from_cost(
        ops.set_replication(f, 2).cost)
    prof["rename_file"] = RTProfile.from_cost(
        ops.rename_file(f + ".new", f + ".mv").cost)
    prof["delete_file"] = RTProfile.from_cost(ops.delete_file(f + ".mv").cost)
    prof["mkdirs"] = RTProfile.from_cost(ops.mkdir(d + "/sub").cost)
    prof["set_quota"] = RTProfile.from_cost(ops.set_quota(d).cost)
    # subtree ops: profile on a modest directory; DES scales by tree size
    from .subtree import SubtreeOps
    st = SubtreeOps(ops)
    sub = d + "/tree"
    ops.mkdir(sub)
    for i in range(8):
        ops.create(f"{sub}/t{i}")
    prof["chmod_subtree"] = RTProfile.from_cost(
        st.chmod_subtree(sub, 0o700).cost)
    prof["chown_subtree"] = RTProfile.from_cost(
        st.chown_subtree(sub, "u2").cost)
    prof["delete_subtree"] = RTProfile.from_cost(st.delete_subtree(sub).cost)
    prof["rename_subtree"] = prof["chmod_subtree"]
    # block-completion profile (write-heavy mixes): measured on a fresh
    # file so none of the profiles above shift
    f3 = d + "/data3.bin"
    ops.create(f3)
    b3 = ops.add_block(f3).value
    prof["complete_block"] = RTProfile.from_cost(
        ops.complete_block(f3, b3, size=1 << 26).cost)
    prof["renew_lease"] = RTProfile.from_cost(ops.renew_lease().cost)
    return prof


# ---------------------------------------------------------------------------
# cluster models
# ---------------------------------------------------------------------------


@dataclass
class SimResult:
    completed: int
    duration: float
    latencies: List[float]
    timeline: List[Tuple[float, int]]    # (second, ops completed in it)

    @property
    def throughput(self) -> float:
        return self.completed / self.duration if self.duration else 0.0

    def latency_avg(self) -> float:
        return sum(self.latencies) / len(self.latencies) \
            if self.latencies else 0.0

    def latency_pct(self, p: float) -> float:
        if not self.latencies:
            return 0.0
        xs = sorted(self.latencies)
        return xs[min(len(xs) - 1, int(p / 100 * len(xs)))]


class HopsFSSim:
    """DES of a HopsFS deployment: M namenodes, one NDB cluster."""

    def __init__(self, *, n_namenodes: int, n_ndb: int,
                 profiles: Dict[str, RTProfile],
                 params: SimParams = DEFAULT_PARAMS, seed: int = 0,
                 timeline_bin: float = 1.0):
        self.p = params
        self.sim = Sim()
        self.rng = random.Random(seed)
        self.profiles = profiles
        self.timeline_bin = timeline_bin
        self.nn_handlers = [Server(self.sim, params.nn_handlers)
                            for _ in range(n_namenodes)]
        self.nn_cpu = [Server(self.sim, params.nn_cores)
                       for _ in range(n_namenodes)]
        self.nn_alive = [True] * n_namenodes
        self.ndb = [Server(self.sim, params.ndb_threads)
                    for _ in range(n_ndb)]
        self.n_ndb = n_ndb
        self.completed = 0
        self.latencies: List[float] = []
        self.timeline: Dict[int, int] = {}
        self.failed_ops = 0
        self.fault_events: List[Tuple[float, str, int]] = []

    # -- client behaviour ---------------------------------------------------
    def start_clients(self, n_clients: int, workload: SpotifyWorkload,
                      *, policy: str = "round_robin") -> None:
        for c in range(n_clients):
            self._client_loop(c, workload, policy,
                              jitter=self.rng.random() * 1e-3)

    def _alive_nns(self) -> List[int]:
        return [i for i, a in enumerate(self.nn_alive) if a]

    def _client_loop(self, cid: int, workload: SpotifyWorkload,
                     policy: str, jitter: float = 0.0) -> None:
        def issue():
            alive = self._alive_nns()
            if not alive:
                self.sim.after(0.05, issue)
                return
            if policy == "sticky":
                nn = alive[cid % len(alive)]
            elif policy == "random":
                nn = self.rng.choice(alive)
            else:
                nn = alive[(cid + self.completed) % len(alive)]
            op = workload.next_op()
            t0 = self.sim.t
            self._run_op(nn, op, lambda: self._done(t0, issue))
        self.sim.after(jitter, issue)

    def _done(self, t0: float, issue_next: Callable[[], None]) -> None:
        self.completed += 1
        lat = self.sim.t - t0
        self.latencies.append(lat)
        sec = int(self.sim.t / self.timeline_bin)
        self.timeline[sec] = self.timeline.get(sec, 0) + 1
        issue_next()

    # -- op execution ---------------------------------------------------------
    def _run_op(self, nn: int, op: WorkloadOp,
                done: Callable[[], None]) -> None:
        prof = self.profiles.get(op.op) or self.profiles["read"]

        def after_rpc():
            if not self.nn_alive[nn]:
                # namenode died: client times out and retries elsewhere
                self.failed_ops += 1
                alive = self._alive_nns()
                if alive:
                    nn2 = self.rng.choice(alive)
                    self.sim.after(self.p.client_nn_rtt,
                                   lambda: self._run_op(nn2, op, done))
                else:
                    self.sim.after(0.05, lambda: self._run_op(
                        nn, op, done))
                return
            self.nn_handlers[nn].acquire(lambda: self._with_handler(
                nn, prof, done))
        self.sim.after(self.p.client_nn_rtt / 2, after_rpc)

    def _build_rts(self, prof: RTProfile) -> List[Tuple[str, bool]]:
        """Expand a profile into (kind, is_local) round trips."""
        rts: List[Tuple[str, bool]] = []
        loc_total = prof.local + prof.remote
        frac_local = prof.local / loc_total if loc_total else 0.0
        for kind, cnt in (("pk", prof.pk), ("batch", prof.batch),
                          ("ppis", prof.ppis), ("is", prof.is_scans),
                          ("fts", prof.fts)):
            for _ in range(cnt):
                rts.append((kind, self.rng.random() < frac_local))
        return rts

    def _exec_rts(self, rts: List[Tuple[str, bool]],
                  finish: Callable[[], None]) -> None:
        """Run a sequence of DB round trips (each queueing on NDB server
        threads), then call ``finish``."""
        p = self.p
        self.rng.shuffle(rts)

        def next_rt(i: int) -> None:
            if i >= len(rts):
                finish()
                return
            kind, local = rts[i]
            rtt = p.db_rtt_local if local else p.db_rtt_remote
            if kind in ("is", "fts"):
                svc = (p.svc_is_per_node if kind == "is"
                       else p.svc_fts_per_node)
                remaining = [self.n_ndb]

                def one_done():
                    remaining[0] -= 1
                    if remaining[0] == 0:
                        self.sim.after(rtt, lambda: next_rt(i + 1))
                for node in self.ndb:
                    node.submit(svc, one_done)
            else:
                svc = {"pk": p.svc_pk, "batch": p.svc_batch,
                       "ppis": p.svc_ppis}[kind]
                node = self.ndb[self.rng.randrange(self.n_ndb)]
                node.submit(svc, lambda: self.sim.after(
                    rtt, lambda: next_rt(i + 1)))
        next_rt(0)

    def _with_handler(self, nn: int, prof: RTProfile,
                      done: Callable[[], None]) -> None:
        """Handler is HELD for the op's full duration (CPU + all DB round
        trips) — this is what makes DB latency throttle NN concurrency."""
        p = self.p

        def finish():
            self.nn_handlers[nn].release()
            self.sim.after(p.client_nn_rtt / 2, done)

        # CPU slice, then DB phase
        self.nn_cpu[nn].submit(
            p.nn_cpu_per_op,
            lambda: self._exec_rts(self._build_rts(prof), finish))

    # -- faults ---------------------------------------------------------------
    def kill_namenode(self, nn: int) -> None:
        self.nn_alive[nn] = False

    def restart_namenode(self, nn: int) -> None:
        self.nn_alive[nn] = True

    def _fault(self, action: str, nn: int) -> None:
        self.fault_events.append((self.sim.t, action, nn))
        if action == "killed":
            self.kill_namenode(nn)
        else:
            self.restart_namenode(nn)

    def schedule_kill(self, at: float, nn: int) -> None:
        """Mirror of a chaos-plan CRASH fault: kill ``nn`` at sim time
        ``at`` and record the event in :attr:`fault_events`."""
        self.sim.after(max(0.0, at - self.sim.t),
                       lambda: self._fault("killed", nn))

    def schedule_restart(self, at: float, nn: int) -> None:
        self.sim.after(max(0.0, at - self.sim.t),
                       lambda: self._fault("restarted", nn))

    # -- elastic membership (the DES mirror of pool.py) -----------------------
    def scale_out_namenode(self) -> int:
        """Append one namenode mid-run (the DES mirror of
        ``ElasticNamenodePool.scale_out``): fresh handler + CPU servers,
        alive immediately — clients pick it up on their next
        ``_alive_nns()`` read. Returns the new namenode's id."""
        nn = len(self.nn_handlers)
        self.nn_handlers.append(Server(self.sim, self.p.nn_handlers))
        self.nn_cpu.append(Server(self.sim, self.p.nn_cores))
        self.nn_alive.append(True)
        self._on_scale_out(nn)
        self.fault_events.append((self.sim.t, "scale_out", nn))
        return nn

    def scale_in_namenode(self) -> Optional[int]:
        """Retire the highest-id alive namenode (never below one member).
        Returns the victim's id, or None if the fleet is already minimal."""
        alive = self._alive_nns()
        if len(alive) <= 1:
            return None
        nn = alive[-1]
        self.nn_alive[nn] = False
        self._on_scale_in(nn)
        self.fault_events.append((self.sim.t, "scale_in", nn))
        return nn

    def _on_scale_out(self, nn: int) -> None:
        """Subclass hook: extend per-namenode parallel state."""

    def _on_scale_in(self, nn: int) -> None:
        """Subclass hook: react to a planned retirement."""

    def schedule_scale_out(self, at: float, n: int = 1) -> None:
        """Scale out by ``n`` namenodes at sim time ``at``."""
        def act():
            for _ in range(n):
                self.scale_out_namenode()
        self.sim.after(max(0.0, at - self.sim.t), act)

    def schedule_scale_in(self, at: float, n: int = 1) -> None:
        """Scale in by ``n`` namenodes at sim time ``at``."""
        def act():
            for _ in range(n):
                self.scale_in_namenode()
        self.sim.after(max(0.0, at - self.sim.t), act)

    # -- running --------------------------------------------------------------
    def run(self, seconds: float) -> SimResult:
        self.sim.run(seconds)
        tl = sorted((b * self.timeline_bin, c)
                    for b, c in self.timeline.items())
        return SimResult(self.completed, seconds, self.latencies, tl)


class BatchedHopsFSSim(HopsFSSim):
    """DES of the batched multi-namenode request pipeline (§2.2, §7.2).

    Clients enqueue into ONE shared queue; each namenode pulls batches of
    up to ``batch_size`` ops whenever it has a free handler (a batch holds
    one handler for its whole duration, so batching amortizes handler
    occupancy exactly as it amortizes round trips). Mirroring the
    functional :meth:`~repro_torch.core.namenode.Namenode.execute_batch`, the
    PK/batch path-validation round trips of each *batchable read group*
    and each *group-mutable mutation group* inside a batch collapse into
    one batched exchange, while per-op scan round trips (PPIS/IS/FTS), the
    mutations' per-row write round trips, and every other op's full
    profile are unchanged. Batches form adaptively: an idle fleet serves
    singleton batches (no added latency); under saturation the queue depth
    grows and batching kicks in — the behaviour that produces the Fig
    7-style throughput-scaling curve replayed by
    ``benchmarks/trace_replay.py``.

    ``planned=True`` mirrors the client-side batch planner
    (:mod:`~repro_torch.core.batch_planner`): instead of FIFO slices, pending
    ops are bucketed by (op type, hint partition) — the OpSpec's own hint
    rule — and each pulled batch drains the largest bucket, so namenodes
    see partition-aligned, type-pure batches whose validation exchanges
    collapse maximally.

    ``adaptive=True`` mirrors the planner's :class:`~repro_torch.core.\
batch_planner.WindowController` feedback loop at DES scale: the pull cap
    is a live window resized after every completed batch from the batch's
    unplannable-op share (the DES analogue of the conflict-pin rate) and
    its executed round trips per op — growth while amortization pays,
    backoff when it regresses.
    """

    def __init__(self, *, batch_size: int = 16, planned: bool = False,
                 adaptive: bool = False, **kw):
        super().__init__(**kw)
        self.batch_size = max(1, batch_size)
        self.planned = planned
        if adaptive:
            from .batch_planner import WindowController
            self.controller = WindowController(
                self.batch_size, min_window=max(1, self.batch_size // 4),
                max_window=self.batch_size * 4)
        else:
            self.controller = None
        self.queue: deque = deque()        # (WorkloadOp, done_cb)
        self.buckets: Dict[object, deque] = {}
        self._bucket_seqs: Dict[object, deque] = {}  # enqueue seq per item
        self.pending = 0
        self._pulls = 0
        self._seq = 0
        self._front_seq = 0                # counts down: requeue priority
        self._inflight = [0] * len(self.nn_handlers)
        self.nn_ops_completed = [0] * len(self.nn_handlers)
        self.batches_executed = 0
        self.batched_ops = 0

    # -- shared-queue client behaviour ---------------------------------
    def _client_loop(self, cid: int, workload, policy: str,
                     jitter: float = 0.0) -> None:
        # `policy` is moot here: ops go to whichever NN pulls the batch
        def issue():
            op = workload.next_op()
            t0 = self.sim.t
            self._enqueue((op, lambda: self._done(t0, issue)))
            self._dispatch()
        self.sim.after(jitter, issue)

    # -- queueing ------------------------------------------------------
    def _enqueue(self, item, *, front: bool = False) -> None:
        if not self.planned:
            (self.queue.appendleft if front
             else self.queue.append)(item)
            return
        op = item[0]
        spec = REGISTRY.get(op.op)
        if spec is not None and (spec.batchable or spec.group_mutable):
            key: object = (op.op,
                           spec.sim_partition(op.path, self.N_PARTITIONS))
        else:
            key = None                     # unplannable: FIFO bucket
        dq = self.buckets.setdefault(key, deque())
        sq = self._bucket_seqs.setdefault(key, deque())
        if front:
            self._front_seq -= 1
            dq.appendleft(item)
            sq.appendleft(self._front_seq)
        else:
            self._seq += 1
            dq.append(item)
            sq.append(self._seq)
        self.pending += 1

    def _requeue(self, item) -> None:
        # a failed batch's ops keep retry priority at the queue front
        self._enqueue(item, front=True)

    def _has_work(self) -> bool:
        return bool(self.queue) or self.pending > 0

    # every Nth planned pull serves the bucket whose HEAD op has waited
    # longest instead of the largest bucket — the real BatchPlanner bounds
    # reordering to a window, so the DES mirror must not let cold
    # (op, partition) buckets starve behind continuously-refilled hot ones
    PULL_AGING = 4

    def _pull_batch(self):
        # the live pull cap: fixed batch_size, or the adaptive window
        cap = (self.controller.window if self.controller is not None
               else self.batch_size)
        if not self.planned:
            k = min(cap, len(self.queue))
            return [self.queue.popleft() for _ in range(k)]
        if not self.buckets:
            return []
        self._pulls += 1
        if self._pulls % self.PULL_AGING == 0:
            # oldest-waiting head op (requeued ops carry negative seqs,
            # so failed batches regain priority first)
            key = min(self.buckets,
                      key=lambda b: self._bucket_seqs[b][0])
        else:
            # drain the largest bucket: partition-aligned dealing
            key = max(self.buckets, key=lambda b: len(self.buckets[b]))
        dq = self.buckets[key]
        sq = self._bucket_seqs[key]
        k = min(cap, len(dq))
        out = [dq.popleft() for _ in range(k)]
        for _ in range(k):
            sq.popleft()
        if not dq:
            del self.buckets[key]
            del self._bucket_seqs[key]
        self.pending -= k
        return out

    # -- elastic membership --------------------------------------------
    def _on_scale_out(self, nn: int) -> None:
        # parallel per-namenode state must grow with the fleet, and the
        # joiner should start pulling from the shared queue immediately
        self._inflight.append(0)
        self.nn_ops_completed.append(0)
        self.sim.after(0.0, self._dispatch)

    # -- dispatch ------------------------------------------------------
    def _dispatch(self) -> None:
        progress = True
        while self._has_work() and progress:
            progress = False
            for nn in self._alive_nns():
                if not self._has_work():
                    break
                if self._inflight[nn] >= self.p.nn_handlers:
                    continue
                batch = self._pull_batch()
                if not batch:
                    break
                self._inflight[nn] += 1
                self._run_batch(nn, batch)
                progress = True

    def _run_batch(self, nn: int, batch) -> None:
        p = self.p

        def after_rpc():
            if not self.nn_alive[nn]:
                # NN died holding the batch: requeue for the survivors
                self._inflight[nn] -= 1
                self.failed_ops += len(batch)
                for item in reversed(batch):
                    self._requeue(item)
                self.sim.after(0.05, self._dispatch)
                return
            self.nn_handlers[nn].acquire(with_handler)

        def with_handler():
            rts = self._merged_rts(batch)

            def finish():
                self.nn_handlers[nn].release()
                self._inflight[nn] -= 1
                self.nn_ops_completed[nn] += len(batch)
                self.batches_executed += 1
                if len(batch) > 1:
                    self.batched_ops += len(batch)
                if self.controller is not None:
                    # feedback: unplannable ops are the DES analogue of
                    # the planner's conflict pins, executed round trips
                    # the amortization signal
                    unplanned = sum(
                        1 for op, _ in batch
                        if (s := REGISTRY.get(op.op)) is None
                        or not (s.batchable or s.group_mutable))
                    self.controller.observe(len(batch), unplanned,
                                            len(rts))
                for _, done_cb in batch:
                    self.sim.after(p.client_nn_rtt / 2, done_cb)
                self._dispatch()
            self.nn_cpu[nn].submit(
                p.nn_cpu_per_op * len(batch),
                lambda: self._exec_rts(rts, finish))
        self.sim.after(p.client_nn_rtt / 2, after_rpc)

    # partition count used to group same-type reads — mirrors the default
    # MetadataStore sharding the functional pipeline groups against
    N_PARTITIONS = 64

    def _merged_rts(self, batch) -> List[Tuple[str, bool]]:
        """Round trips for a batch, collapsed exactly as the functional
        ``Namenode.execute_batch`` does: same-type groupable ops are
        grouped by the HINT PARTITION (path-hashed via the OpSpec hint
        rule), and each multi-op group's validation round trips become ONE
        batched exchange (§5.1) — for batchable reads that absorbs the
        pk+batch validation reads; for group-mutable mutations it absorbs
        the batch-kind exchanges while the per-row write round trips (pk)
        and per-op scans survive. Singleton groups and every other op keep
        their full profiles. Zipf-popular files landing on the same
        partition are what make reactive groups collapse; planned mode
        makes the batches partition-pure so they collapse maximally."""
        groups: Dict[Tuple[str, int], List[RTProfile]] = {}
        rts: List[Tuple[str, bool]] = []
        for op, _ in batch:
            prof = self.profiles.get(op.op) or self.profiles["read"]
            spec = REGISTRY.get(op.op)
            if spec is not None and (spec.batchable
                                     or spec.group_mutable):
                # path -> partition via the OpSpec's hint derivation, the
                # same rule the functional pipeline groups against
                part = spec.sim_partition(op.path, self.N_PARTITIONS)
                groups.setdefault((op.op, part), []).append(prof)
            else:
                rts.extend(self._build_rts(prof))
        for (opname, _part), profs in groups.items():
            if len(profs) == 1:
                rts.extend(self._build_rts(profs[0]))
                continue
            spec = REGISTRY.get(opname)
            is_read = spec is not None and spec.batchable
            loc = sum(pr.local for pr in profs)
            rem = sum(pr.remote for pr in profs)
            frac_local = loc / (loc + rem) if (loc + rem) else 0.0
            # ONE batched exchange replaces the group's validation RTs
            rts.append(("batch", self.rng.random() < frac_local))
            for pr in profs:
                kinds = (("ppis", pr.ppis), ("is", pr.is_scans),
                         ("fts", pr.fts))
                if not is_read:
                    # mutations keep their per-row write round trips
                    kinds = (("pk", pr.pk),) + kinds
                for kind, cnt in kinds:
                    for _ in range(cnt):
                        rts.append((kind,
                                    self.rng.random() < frac_local))
        return rts

    def restart_namenode(self, nn: int) -> None:
        super().restart_namenode(nn)
        self._dispatch()


class HDFSSim:
    """DES of HA-HDFS: one active namenode, global RW lock, failover gap."""

    def __init__(self, *, params: SimParams = DEFAULT_PARAMS, seed: int = 0,
                 timeline_bin: float = 1.0):
        self.p = params
        self.sim = Sim()
        self.rng = random.Random(seed)
        self.handlers = Server(self.sim, params.nn_handlers)
        self.cpu = Server(self.sim, params.nn_cores)
        self.lock = RWLock(self.sim)
        self.down_until = -1.0
        self.completed = 0
        self.latencies: List[float] = []
        self.timeline: Dict[int, int] = {}
        self.timeline_bin = timeline_bin

    def start_clients(self, n_clients: int, workload: SpotifyWorkload
                      ) -> None:
        for c in range(n_clients):
            self._client_loop(workload, jitter=self.rng.random() * 1e-3)

    def _client_loop(self, workload: SpotifyWorkload,
                     jitter: float = 0.0) -> None:
        def issue():
            op = workload.next_op()
            t0 = self.sim.t
            self._run_op(op, lambda: self._done(t0, issue))
        self.sim.after(jitter, issue)

    def _done(self, t0: float, issue_next: Callable[[], None]) -> None:
        self.completed += 1
        self.latencies.append(self.sim.t - t0)
        sec = int(self.sim.t / self.timeline_bin)
        self.timeline[sec] = self.timeline.get(sec, 0) + 1
        issue_next()

    def _run_op(self, op: WorkloadOp, done: Callable[[], None]) -> None:
        p = self.p
        op_spec = REGISTRY.get(op.op)
        is_read = op_spec is not None and op_spec.read_only

        def after_rpc():
            if self.sim.t < self.down_until:
                # failover window: RPCs fail; client retries after backoff
                self.sim.after(self.down_until - self.sim.t + 0.05,
                               lambda: self._run_op(op, done))
                return
            self.handlers.acquire(with_handler)

        def with_handler():
            cpu = p.hdfs_cpu_read if is_read else p.hdfs_cpu_write
            hold = p.hdfs_lock_read_hold if is_read \
                else p.hdfs_lock_write_hold
            spec = REGISTRY.get(op.op)
            if spec is not None and spec.subtree:
                hold *= 40      # large in-heap subtree mutation

            def fin():
                self.handlers.release()
                self.sim.after(p.client_nn_rtt / 2, done)
            self.cpu.submit(cpu, lambda: self.lock.submit(
                not is_read, hold, fin))
        self.sim.after(p.client_nn_rtt / 2, after_rpc)

    def kill_active(self) -> float:
        """Failover: downtime = detection + edit-log replay (§7.6.1)."""
        gap = self.p.failover_detect + self.p.failover_replay
        self.down_until = self.sim.t + gap
        return gap

    def run(self, seconds: float) -> SimResult:
        self.sim.run(seconds)
        tl = sorted((b * self.timeline_bin, c)
                    for b, c in self.timeline.items())
        return SimResult(self.completed, seconds, self.latencies, tl)
