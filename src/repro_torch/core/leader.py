"""Leader election and membership through the database (paper §3, ref [57]).

HopsFS uses the database as shared memory: every namenode periodically
writes a heartbeat row; a namenode is *alive* iff it has written within a
bounded number of ticks; the leader is the alive namenode with the smallest
id. The leader runs housekeeping (replication manager, block-report load
balancing, lease recovery).

Client liveness rides the SAME logical clock: lease renewals (`lease`
table, ``fs.HopsFSOps.renew_lease``) are stamped with ``now``, and a lease
not renewed within the lease limit is expired — which is what
``Namenode.recover_leases`` (leader-only housekeeping) reclaims, unblocking
other writers' ``append``/``add_block``. Dead clients are thus detected
exactly like dead namenodes: bounded heartbeat staleness against this
clock.

Time here is a logical clock advanced by the caller (the DES or the runtime
driver), which makes the protocol deterministic and testable.
"""
from __future__ import annotations

from typing import Any, List, Optional

from .store import MetadataStore
from .transactions import Transaction


class LeaderElection:
    #: logical liveness clock — namenode heartbeats AND client lease
    #: renewals are stamped against it (advanced by tick())
    now: int = 0

    def __init__(self, store: MetadataStore, *, max_missed: int = 2):
        self.store = store
        self.max_missed = max_missed
        self.now = 0
        #: chaos hook (chaos.FaultInjector.install): the "heartbeat" site —
        #: a crash here is a namenode dying WITH its liveness proof, the
        #: purest form of §7.6 failure (detected after max_missed ticks)
        self.chaos: Optional[Any] = None

    def tick(self) -> None:
        self.now += 1

    def heartbeat(self, namenode_id: int) -> None:
        """One bounded-time write to the DB == liveness proof ([57])."""
        if self.chaos is not None \
                and not self.chaos.allow_heartbeat(namenode_id):
            return      # the victim died instead of proving liveness
        with Transaction(self.store,
                         partition_hint=("leader", namenode_id)) as txn:
            txn.write("leader", {"namenode_id": namenode_id,
                                 "last_hb": self.now})

    def alive(self) -> List[int]:
        rows = self.store.table("leader").scan_all(
            lambda r: self.now - r["last_hb"] <= self.max_missed)
        return sorted(r["namenode_id"] for r in rows)

    def is_alive(self, namenode_id: int) -> bool:
        row = self.store.table("leader").get((namenode_id,))
        return row is not None and self.now - row["last_hb"] <= self.max_missed

    def leader(self) -> Optional[int]:
        a = self.alive()
        return a[0] if a else None

    def remove(self, namenode_id: int) -> None:
        self.store.table("leader").delete((namenode_id,))
