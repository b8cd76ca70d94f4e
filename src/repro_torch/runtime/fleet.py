"""Fleet runtime: heartbeats, failover, elastic re-meshing.

The control loop a 1000-node deployment runs around the train step:

  * every worker heartbeats through the metadata plane's leader-election
    table (the paper's "alive = can write to the DB in bounded time");
  * the LEADER worker runs housekeeping (checkpoint GC, shard re-dispatch);
  * on worker loss: the fleet shrinks to the largest usable mesh
    (data-axis multiple), restores the latest committed checkpoint, and
    continues — `elastic_remesh` computes the new (data, model) shape;
  * on worker join: grow at the next checkpoint boundary.

This module is a pure control plane, holding no tensors, so it is testable
deterministically; a training launcher wires it to real steps.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..core.leader import LeaderElection
from ..metaplane import MetadataPlane


@dataclass
class WorkerState:
    worker_id: int
    alive: bool = True
    step: int = 0


def elastic_remesh(n_workers: int, *, model_axis: int,
                   chips_per_worker: int = 4) -> Tuple[int, int]:
    """Largest (data, model) mesh using <= n_workers * chips_per_worker
    chips with the fixed model axis (TP degree is pinned by weight shapes;
    DP shrinks/grows elastically)."""
    chips = n_workers * chips_per_worker
    data = max(1, chips // model_axis)
    # data axis must divide the global batch in the caller; round down to a
    # power of two for predictable batch slicing
    p = 1
    while p * 2 <= data:
        p *= 2
    return p, model_axis


class FleetRuntime:
    def __init__(self, plane: MetadataPlane, n_workers: int, *,
                 model_axis: int = 16, chips_per_worker: int = 4,
                 hb_timeout: int = 2):
        self.plane = plane
        self.election = LeaderElection(plane.store, max_missed=hb_timeout)
        self.workers = {i: WorkerState(i) for i in range(n_workers)}
        self.model_axis = model_axis
        self.chips_per_worker = chips_per_worker
        self.mesh_shape = elastic_remesh(
            n_workers, model_axis=model_axis,
            chips_per_worker=chips_per_worker)
        self.remesh_events: List[Tuple[int, Tuple[int, int]]] = []
        self.now = 0
        for w in self.workers.values():
            self.election.heartbeat(w.worker_id)

    # -- heartbeat round ----------------------------------------------------
    def tick(self) -> None:
        self.now += 1
        self.election.tick()
        for w in self.workers.values():
            if w.alive:
                self.election.heartbeat(w.worker_id)

    def alive_workers(self) -> List[int]:
        return [w.worker_id for w in self.workers.values() if w.alive]

    def leader(self) -> Optional[int]:
        return self.election.leader()

    # -- failures / elasticity -----------------------------------------------
    def fail_worker(self, worker_id: int) -> None:
        self.workers[worker_id].alive = False

    def join_worker(self, worker_id: int) -> None:
        self.workers.setdefault(worker_id, WorkerState(worker_id))
        self.workers[worker_id].alive = True
        self.election.heartbeat(worker_id)

    def maybe_remesh(self) -> Optional[Tuple[int, int]]:
        """Called after heartbeats: if the alive set no longer matches the
        mesh, compute the new mesh and signal a restore-from-checkpoint."""
        n = len(self.alive_workers())
        new = elastic_remesh(n, model_axis=self.model_axis,
                             chips_per_worker=self.chips_per_worker)
        if new != self.mesh_shape:
            self.mesh_shape = new
            self.remesh_events.append((self.now, new))
            return new
        return None
