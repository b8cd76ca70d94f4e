"""HDFS-style ``DFSClient`` facade over the typed operation protocol.

The client-facing API of the reproduction: typed methods
(``mkdirs/create/open/rename/delete/stat/ls/...``) returning typed results
(:class:`FileStatus`, :class:`BlockLocation`, ...), executed through the
op registry on a fleet of stateless namenodes with the composable
middleware stack of :mod:`~repro_torch.core.middleware`:

  * ``subtree_retry`` — ops that voluntarily abort on a live subtree lock
    (§6.3) are retried with backoff before :class:`SubtreeLockedError`
    surfaces;
  * ``failover``      — a namenode dying mid-op is transparent (§7.6.1);
  * batching          — :meth:`DFSClient.batch` defers calls and flushes
    them through :meth:`Namenode.execute_batch` (grouped path validation,
    §5.1), and :meth:`DFSClient.run_trace` drives whole traces through the
    shared-queue :class:`RequestPipeline`.

Every operation the registry knows — including ones registered after
import, see ``docs/API.md`` — is reachable via :meth:`call`; the named
methods are typed sugar over it.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Type)

from .admission import DeadlineExpired, OverloadShed
from .fs import (FSError, FileAlreadyExists, FileNotFound, LeaseConflict,
                 OpResult, SubtreeLockedError)
from .hint_cache import InodeHintCache, absorb_response
from .middleware import (CallContext, Handler, Middleware, compose, failover,
                         membership_refresh, subtree_retry, txn_retry)
from .namenode import (Client, Namenode, NamenodeCluster, PipelineStats,
                       RequestPipeline)
from .ops_registry import REGISTRY, WorkloadOp
from .store import (LockTimeout, NetworkPartition, NodeGroupDown,
                    RowNotFound, StoreError, TransactionAborted)

# ---------------------------------------------------------------------------
# typed results
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FileStatus:
    """``stat`` result — the HDFS ``FileStatus`` equivalent."""
    path: str
    inode_id: int
    is_dir: bool
    perm: int
    owner: str
    group: str
    size: int
    repl: int
    mtime: float


@dataclass(frozen=True)
class BlockLocation:
    """One block of an opened file with its replica locations."""
    block_id: int
    size: int
    datanodes: Tuple[int, ...]


@dataclass(frozen=True)
class ContentSummary:
    path: str
    children: int
    size: int


@dataclass(frozen=True)
class DeleteSummary:
    path: str
    deleted: int          # inodes removed (1 for a plain file)
    recursive: bool


@dataclass(frozen=True)
class TruncateSummary:
    path: str
    size: int
    removed_blocks: int


@dataclass(frozen=True)
class ConcatSummary:
    target: str
    blocks_moved: int
    size: int


#: error-name -> class, used to rehydrate typed errors out of batched
#: :class:`~repro_torch.core.namenode.OpOutcome` records
ERROR_TYPES: Dict[str, Type[Exception]] = {
    cls.__name__: cls
    for cls in (FSError, FileNotFound, FileAlreadyExists, LeaseConflict,
                SubtreeLockedError, StoreError, LockTimeout, NodeGroupDown,
                TransactionAborted, RowNotFound, NetworkPartition,
                DeadlineExpired, OverloadShed)
}


def error_for(name: Optional[str], detail: str = "") -> Exception:
    """Typed exception for an outcome's recorded error name."""
    return ERROR_TYPES.get(name or "StoreError", StoreError)(detail or name)


# ---------------------------------------------------------------------------
# the facade
# ---------------------------------------------------------------------------


class DFSClient:
    """Typed client over a :class:`NamenodeCluster`.

    ``middleware`` defaults to ``[failover(...), subtree_retry(...)]``;
    pass your own stack to change retry policy or to add concerns
    (tracing, circuit breaking) — the terminal handler always picks a live
    namenode per attempt and invokes through the registry.
    """

    def __init__(self, cluster: NamenodeCluster, *, policy: str = "sticky",
                 seed: int = 0, subtree_retries: int = 8,
                 subtree_backoff: float = 0.002,
                 failover_attempts: int = 8,
                 middleware: Optional[Sequence[Middleware]] = None,
                 retry_budget: Any = None, breakers: Any = None,
                 sleep: Callable[[float], None] = time.sleep):
        self.cluster = cluster
        self._selector = Client(cluster, policy=policy, seed=seed,
                                board=breakers)
        self.failover_attempts = failover_attempts
        #: shared token-bucket retry budget (admission.RetryBudget) every
        #: retrying middleware of this client draws from; refilled once
        #: per logical call (``note_call`` in :meth:`call`)
        self.retry_budget = retry_budget
        #: per-namenode circuit breakers (admission.BreakerBoard): the
        #: selector routes around open breakers, and a breaker-recording
        #: middleware wraps every attempt
        self.breakers = breakers
        if middleware is None:
            # deterministic per-client jitter: seeded, so replays
            # reproduce while concurrent clients still de-synchronize
            jitter = random.Random(seed ^ 0x5EED)
            middleware = [
                failover(attempts=failover_attempts,
                         on_failover=self._reset_sticky,
                         sleep=sleep, jitter=jitter,
                         budget=retry_budget),
                subtree_retry(retries=subtree_retries,
                              backoff=subtree_backoff, sleep=sleep,
                              budget=retry_budget),
                txn_retry(sleep=sleep, jitter=jitter,
                          budget=retry_budget),
                # §7.5: timed-out txns aborted, re-run
            ]
            if breakers is not None:
                from .admission import circuit_breaker
                # inside failover, outside the per-error retries: every
                # failover attempt records on the breaker of the
                # namenode that served it
                middleware.insert(1, circuit_breaker(breakers))
        self.middleware: List[Middleware] = list(middleware)
        self._handler: Handler = compose(self.middleware, self._terminal)
        self.retries = 0
        #: the client-side inode hint cache (§5.1 applied to the CLIENT):
        #: warmed from the (parent_id, name) -> inode_id resolutions every
        #: namenode response piggybacks (``OpResult.hints``), invalidated
        #: on destructive ops, and handed to the planned pipeline so the
        #: batch planner resolves against responses this client actually
        #: saw instead of reading namenode caches — see docs/HINTS.md
        self.hint_cache = InodeHintCache()
        #: elastic pool this client follows (None on a static fleet)
        self.pool: Any = None

    # -- plumbing -------------------------------------------------------
    def attach_pool(self, pool: Any) -> None:
        """Follow an :class:`~repro_torch.core.pool.ElasticNamenodePool`: this
        client's hint cache becomes a pre-warm donor for joiners, and a
        ``membership_refresh`` middleware (outermost — it must see every
        attempt) drops the sticky namenode selection whenever the pool's
        membership epoch moves, so calls rebalance onto the new fleet
        without interrupting anything in flight. ``run_trace`` also starts
        ticking the pool per planned window."""
        self.pool = pool
        pool.register_client_cache(self.hint_cache)
        self.middleware.insert(
            0, membership_refresh(pool, self._reset_sticky))
        self._handler = compose(self.middleware, self._terminal)

    def _reset_sticky(self, ctx: CallContext) -> None:
        self._selector._sticky = None

    def _pick(self) -> Namenode:
        return self._selector._pick()

    def _terminal(self, ctx: CallContext) -> OpResult:
        nn = self._pick()
        ctx.namenode = nn
        ctx.attempts += 1
        return nn.invoke(ctx.wop)

    def _absorb(self, wop: WorkloadOp, res: OpResult) -> None:
        """Close the hint loop for one response: invalidate what a
        destructive op removed/moved, then warm the client cache from the
        piggybacked resolutions (the shared
        :func:`~repro_torch.core.hint_cache.absorb_response` rule)."""
        absorb_response(self.hint_cache, wop, REGISTRY.get(wop.op),
                        res.hints)

    def call(self, op: str, path: str = "", path2: Optional[str] = None,
             **args: Any) -> OpResult:
        """Execute any registered op through the middleware stack.  The
        named methods below are typed wrappers over this."""
        if op not in REGISTRY:
            raise KeyError(f"unknown op {op!r}; registered: "
                           f"{sorted(REGISTRY.names())}")
        deadline = args.pop("deadline", None)
        tenant = args.pop("tenant", None)
        wop = WorkloadOp(op, path, path2, args=args,
                         deadline=deadline, tenant=tenant)
        ctx = CallContext(op=op, wop=wop, deadline=deadline)
        if self.retry_budget is not None:
            self.retry_budget.note_call()
        try:
            res = self._handler(ctx)
            self._absorb(wop, res)
            return res
        finally:
            self.retries += ctx.retries

    # -- namespace ------------------------------------------------------
    def mkdir(self, path: str, perm: int = 0o755) -> int:
        return self.call("mkdir", path, perm=perm).value

    def mkdirs(self, path: str, perm: int = 0o755) -> Optional[int]:
        return self.call("mkdirs", path, perm=perm).value

    def create(self, path: str, *, repl: int = 3, client: str = "client",
               overwrite: bool = False) -> int:
        return self.call("create", path, repl=repl, client=client,
                         overwrite=overwrite).value

    def stat(self, path: str) -> FileStatus:
        v = self.call("stat", path).value
        return FileStatus(path=path, inode_id=v["id"], is_dir=v["is_dir"],
                          perm=v["perm"], owner=v["owner"], group=v["group"],
                          size=v["size"], repl=v["repl"], mtime=v["mtime"])

    def exists(self, path: str) -> bool:
        try:
            self.call("stat", path)
            return True
        except FileNotFound:
            return False

    def ls(self, path: str) -> Tuple[str, ...]:
        return tuple(self.call("ls", path).value)

    def open(self, path: str) -> Tuple[BlockLocation, ...]:
        """getBlockLocations — the dominant op of the Spotify mix."""
        return tuple(BlockLocation(b["block"], b["size"],
                                   tuple(b["locations"]))
                     for b in self.call("read", path).value)

    def rename(self, src: str, dst: str) -> None:
        """mv: routes to the subtree protocol (§6) for directories."""
        op = "rename_subtree" if self.stat(src).is_dir else "rename_file"
        self.call(op, src, dst)

    def delete(self, path: str, recursive: bool = False) -> DeleteSummary:
        st = self.stat(path)
        if st.is_dir:
            if not recursive:
                raise FSError(f"directory {path} (use recursive=True)")
            v = self.call("delete_subtree", path).value
            return DeleteSummary(path, v["deleted"], True)
        self.call("delete_file", path)
        return DeleteSummary(path, 1, False)

    # -- attributes -----------------------------------------------------
    def chmod(self, path: str, perm: int) -> None:
        op = "chmod_subtree" if self.stat(path).is_dir else "chmod_file"
        self.call(op, path, perm=perm)

    def chown(self, path: str, owner: str) -> None:
        op = "chown_subtree" if self.stat(path).is_dir else "chown_file"
        self.call(op, path, owner=owner)

    def set_replication(self, path: str, repl: int) -> None:
        self.call("set_replication", path, repl=repl)

    def set_quota(self, path: str, *, ns_quota: int = -1,
                  ss_quota: int = -1) -> None:
        self.call("set_quota", path, ns_quota=ns_quota, ss_quota=ss_quota)

    def content_summary(self, path: str) -> ContentSummary:
        v = self.call("content_summary", path).value
        return ContentSummary(path, v["children"], v["size"])

    # -- block protocol -------------------------------------------------
    def append(self, path: str, *, client: str = "client") -> int:
        """Reopen a file for append: takes the lease over for ``client``.
        Raises :class:`~repro_torch.core.fs.LeaseConflict` while another
        client's live lease covers the file."""
        return self.call("append", path, client=client).value

    def add_block(self, path: str, *, client: str = "client") -> int:
        return self.call("add_block", path, client=client).value

    def complete_block(self, path: str, block_id: int = -1, *,
                       size: int, client: str = "client") -> None:
        """Finalize a block (``block_id=-1`` means the file's last
        allocated block)."""
        self.call("complete_block", path, block_id=block_id, size=size,
                  client=client)

    def renew_lease(self, *, client: str = "client") -> None:
        """Client heartbeat: keeps ``client``'s lease live so the leader's
        lease recovery does not reclaim its files under construction."""
        self.call("renew_lease", client=client)

    def recover_lease(self, path: str, *, client: str = "client") -> bool:
        """HDFS ``recoverLease``: force recovery of ``path``'s lease for a
        new writer once the holder outlived the SOFT lease limit, instead
        of waiting for the leader's hard-limit sweep. Returns True when a
        lease was recovered, False when there was nothing to recover; a
        holder still inside the soft limit raises
        :class:`~repro_torch.core.fs.LeaseConflict`."""
        return bool(self.call("recover_lease", path, client=client).value)

    def truncate(self, path: str, new_size: int = 0) -> TruncateSummary:
        v = self.call("truncate", path, new_size=new_size).value
        return TruncateSummary(path, v["size"], v["removed_blocks"])

    def concat(self, target: str, srcs: Sequence[str]) -> ConcatSummary:
        v = self.call("concat", target, srcs=list(srcs)).value
        return ConcatSummary(target, v["blocks_moved"], v["size"])

    # -- batching -------------------------------------------------------
    def batch(self) -> "BatchCall":
        """Defer calls and flush them as ONE pulled batch through
        :meth:`Namenode.execute_batch` (runs of same-type reads validated
        with one grouped PK exchange per partition, §5.1)::

            with client.batch() as b:
                h1, h2 = b.stat("/a"), b.open("/a/f")
            print(h1.result().owner, h2.result()[0].block_id)
        """
        return BatchCall(self)

    def run_trace(self, wops: Sequence[WorkloadOp], *, batch_size: int = 16,
                  concurrent: bool = False, planned: bool = False,
                  window: Optional[int] = None,
                  adaptive: bool = True,
                  hint_routing: Optional[bool] = None,
                  admission: Any = None) -> PipelineStats:
        """Replay a trace through the batched request pipeline over this
        client's cluster (the Fig 7 methodology). ``planned=True`` routes
        through the client-side columnar batch planner
        (:mod:`~repro_torch.core.batch_planner`): partition-aligned, type-sorted
        batches with client-side path resolutions attached, instead of
        reactive FIFO dealing. The planned pipeline is closed-loop: it
        plans against THIS client's ``hint_cache`` (warmed by response
        piggybacking, shared with the facade's own calls) and resizes its
        planning window adaptively (``adaptive=False`` pins the window).
        With a pool attached (:meth:`attach_pool`) the pipeline ticks it
        once per executed window and routes batches hint-aware — override
        with ``hint_routing`` either way."""
        if planned:
            from .batch_planner import PlannedRequestPipeline
            return PlannedRequestPipeline(self.cluster,
                                          batch_size=batch_size,
                                          concurrent=concurrent,
                                          window=window,
                                          client_cache=self.hint_cache,
                                          adaptive=adaptive,
                                          pool=self.pool,
                                          hint_routing=hint_routing,
                                          admission=admission,
                                          breakers=self.breakers).run(
                                              wops)
        return RequestPipeline(self.cluster, batch_size=batch_size,
                               concurrent=concurrent).run(wops)


# ---------------------------------------------------------------------------
# deferred-batch plumbing
# ---------------------------------------------------------------------------


class BatchHandle:
    """Future-like handle for one deferred call in a :class:`BatchCall`."""

    __slots__ = ("_value", "_error", "_done")

    def __init__(self) -> None:
        self._value: Any = None
        self._error: Optional[Exception] = None
        self._done = False

    def result(self) -> Any:
        if not self._done:
            raise RuntimeError("batch not flushed yet (exit the context)")
        if self._error is not None:
            raise self._error
        return self._value


class BatchCall:
    """Collects deferred ops; the context exit flushes them as one batch
    on a single namenode (with dead-namenode failover)."""

    def __init__(self, client: DFSClient):
        self._client = client
        self._wops: List[WorkloadOp] = []
        self._handles: List[BatchHandle] = []
        self._mappers: List[Callable[[Any], Any]] = []

    def submit(self, op: str, path: str = "", path2: Optional[str] = None,
               _mapper: Callable[[Any], Any] = lambda v: v,
               **args: Any) -> BatchHandle:
        if op not in REGISTRY:
            raise KeyError(f"unknown op {op!r}")
        h = BatchHandle()
        self._wops.append(WorkloadOp(op, path, path2, args=args))
        self._handles.append(h)
        self._mappers.append(_mapper)
        return h

    # typed sugar for the batchable reads
    def stat(self, path: str) -> BatchHandle:
        return self.submit(
            "stat", path,
            _mapper=lambda v: FileStatus(
                path=path, inode_id=v["id"], is_dir=v["is_dir"],
                perm=v["perm"], owner=v["owner"], group=v["group"],
                size=v["size"], repl=v["repl"], mtime=v["mtime"]))

    def open(self, path: str) -> BatchHandle:
        return self.submit(
            "read", path,
            _mapper=lambda v: tuple(
                BlockLocation(b["block"], b["size"], tuple(b["locations"]))
                for b in v))

    def ls(self, path: str) -> BatchHandle:
        return self.submit("ls", path, _mapper=tuple)

    def flush(self) -> None:
        """Execute the deferred ops on one namenode; ops in flight when a
        namenode dies (§7.6.1) — whether the whole batch call raised or
        individual outcomes recorded the death — are retried on a
        survivor. The batch is reusable after flush."""
        todo = list(zip(self._wops, self._handles, self._mappers))
        self._wops, self._handles, self._mappers = [], [], []
        last: Optional[Exception] = None
        for _ in range(max(1, self._client.failover_attempts)):
            if not todo:
                return
            nn = self._client._pick()
            try:
                outcomes = nn.execute_batch([w for w, _, _ in todo])
            except StoreError as e:
                # died holding the batch, or unreachable: nothing executed
                if not nn.alive or isinstance(e, NetworkPartition):
                    last = e
                    self._client.retries += 1
                    self._client._reset_sticky(CallContext(op="batch"))
                    continue
                raise
            retry = []
            for (w, h, mapper), oc in zip(todo, outcomes):
                if not oc.ok and oc.error == "StoreError" and not nn.alive:
                    retry.append((w, h, mapper))   # in-flight death: redo
                    continue
                h._done = True
                if oc.ok:
                    h._value = mapper(oc.result.value)
                    self._client._absorb(w, oc.result)
                else:
                    h._error = error_for(oc.error)
            if not retry:
                return
            todo = retry
            self._client.retries += 1
            self._client._reset_sticky(CallContext(op="batch"))
            last = StoreError("namenode died mid-batch")
        raise last  # type: ignore[misc]

    def __enter__(self) -> "BatchCall":
        return self

    def __exit__(self, et, ev, tb) -> bool:
        if et is None:
            self.flush()
        return False
