"""Composable client-side call middleware (one implementation, three users).

The retry/failover behaviour that HopsFS clients implement — voluntary
re-try after a subtree-lock abort (§6.3) and transparent failover to
another namenode when one dies (§7.6.1) — used to be duplicated between
``Namenode._safe_exec``, ``Client.execute`` and ``RequestPipeline.run``.
It now lives here as middleware over a plain call chain:

    handler  = compose([failover(...), subtree_retry(...)], terminal)
    result   = handler(CallContext(op=..., wop=...))

A *terminal* handler performs one attempt (picking a namenode and invoking
the op through the registry) and records the namenode it used on the
context; middleware around it decide whether an exception is retryable.
``DFSClient`` accepts a custom middleware stack, so policies (more
aggressive backoff, circuit breaking, tracing) compose without touching
the namenode or the registry.

Overload protection (docs/ROBUSTNESS.md): every retrying middleware here
takes an injectable ``sleep`` (tests pass a fake clock — no wall-clock
sleeps), an optional ``jitter`` RNG that de-synchronizes backoff so
simultaneous aborters do not re-collide in lockstep (a retry herd), and
an optional shared ``budget`` (:class:`~repro_torch.core.admission.RetryBudget`)
— a token bucket ALL retry middleware on a client draw from, so the
fleet-wide retry rate is bounded by a fraction of the call rate instead
of multiplying per-middleware attempt counters."""
from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

from .fs import SubtreeLockedError
from .ops_registry import REGISTRY, WorkloadOp
from .store import (LockTimeout, NetworkPartition, StoreError,
                    TransactionAborted)


@dataclass
class CallContext:
    """State threaded through one logical call (possibly many attempts)."""
    op: str
    wop: Optional[WorkloadOp] = None
    namenode: Any = None        # namenode used by the LAST attempt
    attempts: int = 0
    retries: int = 0            # subtree-abort + failover retries
    #: latest election-clock tick by which the call must complete (copied
    #: from ``wop.deadline`` by DFSClient); admission-aware namenodes shed
    #: the op once the clock passes it instead of executing stale work
    deadline: Optional[int] = None


Handler = Callable[[CallContext], Any]
Middleware = Callable[[Handler], Handler]


def compose(middleware: Sequence[Middleware], terminal: Handler) -> Handler:
    """Wrap ``terminal`` with the middleware, first entry outermost."""
    h = terminal
    for mw in reversed(list(middleware)):
        h = mw(h)
    return h


def _jittered(base: float, jitter: Optional[random.Random]) -> float:
    """Equal-jitter: half the nominal backoff deterministic, half random —
    concurrent retriers spread over [base/2, base) instead of re-colliding
    at exactly ``base`` (the classic synchronized retry herd)."""
    if jitter is None:
        return base
    return base * (0.5 + 0.5 * jitter.random())


def _spend(budget: Any, last: Exception) -> None:
    """Gate one retry on the shared token bucket: an exhausted budget
    surfaces the LAST error immediately instead of amplifying load."""
    if budget is not None and not budget.try_spend():
        raise last


def subtree_retry(retries: int = 8, backoff: float = 0.002,
                  sleep: Callable[[float], None] = time.sleep,
                  budget: Any = None) -> Middleware:
    """Ops that hit a live subtree lock voluntarily aborted (§6.3); retry
    them with linear backoff exactly as the HopsFS client does, surfacing
    :class:`SubtreeLockedError` once the attempt count — or the shared
    retry ``budget`` — is exhausted."""
    def mw(nxt: Handler) -> Handler:
        def handler(ctx: CallContext) -> Any:
            last: Optional[Exception] = None
            for attempt in range(max(1, retries)):
                try:
                    return nxt(ctx)
                except SubtreeLockedError as e:
                    last = e
                    if attempt < max(1, retries) - 1:
                        _spend(budget, e)
                    ctx.retries += 1
                    if backoff:
                        sleep(backoff * (attempt + 1))
            raise last  # type: ignore[misc]
        return handler
    return mw


def txn_retry(retries: int = 3, backoff: float = 0.005,
              sleep: Callable[[float], None] = time.sleep,
              budget: Any = None,
              jitter: Optional[random.Random] = None) -> Middleware:
    """Paper §7.5: transactions that hit the NDB inactive timeout (or were
    aborted by the engine) are automatically retried — the timed-out
    transaction aborted atomically, so re-running the op is safe and is
    exactly what the HopsFS DAL does (the client-side twin of
    ``transactions.run_with_retry``). Only genuinely concurrent execution
    can time out (a single-threaded run never waits on a row lock), so
    this middleware is inert on the deterministic pipelines; under
    concurrent workers it keeps a >1.2 s scheduler stall from surfacing a
    spurious mutation failure.

    Subtree ops are NOT retried here: they span many chunk transactions
    (§6 phase 3), so earlier chunks may already be committed when a later
    one times out — a blind re-run would return a partial count. Their
    timeout surfaces to the caller, exactly as before this middleware
    existed."""
    def mw(nxt: Handler) -> Handler:
        def handler(ctx: CallContext) -> Any:
            last: Optional[Exception] = None
            attempts = max(1, retries) + 1
            for attempt in range(attempts):
                try:
                    return nxt(ctx)
                except (LockTimeout, TransactionAborted) as e:
                    spec = REGISTRY.get(ctx.op)
                    if spec is not None and spec.subtree:
                        raise               # multi-txn op: not re-runnable
                    last = e
                    if attempt < attempts - 1:
                        _spend(budget, e)
                    ctx.retries += 1
                    if backoff and attempt < attempts - 1:
                        sleep(_jittered(backoff * (2 ** attempt), jitter))
            raise last  # type: ignore[misc]
        return handler
    return mw


def membership_refresh(pool: Any,
                       on_change: Callable[[CallContext], None]
                       ) -> Middleware:
    """Elastic-membership awareness for clients: before each attempt,
    compare the pool's ``membership_epoch`` against the epoch seen at the
    previous call through this middleware; on a change, invoke
    ``on_change(ctx)`` BEFORE the attempt proceeds. ``DFSClient`` wires
    ``on_change`` to drop its sticky namenode selection, so calls
    rebalance onto the new fleet lazily — in-flight calls are never
    interrupted, and leases survive because lease state lives in the
    store, not the namenode (the pool's scale-in already ran the leader's
    ``recover_leases``/``scrub_leases`` housekeeping)."""
    seen = [pool.membership_epoch]

    def mw(nxt: Handler) -> Handler:
        def handler(ctx: CallContext) -> Any:
            cur = pool.membership_epoch
            if cur != seen[0]:
                seen[0] = cur
                on_change(ctx)
            return nxt(ctx)
        return handler
    return mw


def failover(attempts: int = 8,
             on_failover: Optional[Callable[[CallContext], None]] = None,
             *, backoff: float = 0.0,
             sleep: Callable[[float], None] = time.sleep,
             jitter: Optional[random.Random] = None,
             budget: Any = None) -> Middleware:
    """Transparent namenode failover (§7.6.1): a :class:`StoreError` from a
    namenode that is now DEAD means the op was in flight when it died —
    retry elsewhere. A :class:`NetworkPartition` is retried even though
    the namenode is alive: to the client an unreachable namenode and a
    dead one are the same thing, and nothing executed on the other side.
    Errors from a live, reachable namenode are genuine outcomes
    (FileNotFound, quota, ...) and propagate unchanged.

    ``backoff`` (default 0 — failover itself is immediate, the dead
    namenode will not get better) enables exponential, jittered waits
    between attempts for deployments where partitions heal with time;
    the shared ``budget`` bounds how many failover retries the client
    may spend fleet-wide."""
    def mw(nxt: Handler) -> Handler:
        def handler(ctx: CallContext) -> Any:
            last: Optional[Exception] = None
            n = max(1, attempts)
            for attempt in range(n):
                try:
                    return nxt(ctx)
                except SubtreeLockedError:
                    raise               # inner middleware's business
                except StoreError as e:
                    nn = ctx.namenode
                    if isinstance(e, NetworkPartition) or (
                            nn is not None
                            and not getattr(nn, "alive", True)):
                        last = e
                        if attempt < n - 1:
                            _spend(budget, e)
                        ctx.retries += 1
                        if on_failover is not None:
                            on_failover(ctx)
                        if backoff and attempt < n - 1:
                            sleep(_jittered(backoff * (2 ** attempt),
                                            jitter))
                        continue
                    raise
            raise last  # type: ignore[misc]
        return handler
    return mw
