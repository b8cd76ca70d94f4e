"""The training framework's metadata plane = HopsFS consumed as a library.

This is the paper's technique integrated as a first-class feature: the
cluster's checkpoint manifests, dataset registry, and job ledger live in the
HopsFS namespace (hierarchical, partitioned by parent — so listing one
step's shards is a single partition-pruned scan) served by stateless
namenodes with transparent failover.

Namespace layout:

    /jobs/<job>/ledger/step-<n>           (job progress rows)
    /ckpt/<job>/step-<n>/<param-path>.shard-<k>    (one file per tensor shard)
    /data/<dataset>/shard-<k>             (input shards; straggler
                                           re-dispatch bookkeeping)

At 512 chips, one nemotron-340B checkpoint writes ~360 param leaves x 512
shards ~ O(10^5) manifest rows; at 1000+ nodes with frequent checkpoints
the single-coordinator design (= HDFS' single NN) saturates exactly as the
paper describes — the scale-out metadata plane is what keeps checkpoint
commit latency flat (the JAX package's benchmarks/bench_ckpt_metadata.py
measures this for the reference).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from ..core import (Client, FileNotFound, MetadataStore, NamenodeCluster,
                    format_fs)


@dataclass
class CheckpointManifest:
    job: str
    step: int
    shards: Dict[str, List[int]]        # param path -> shard ids present
    complete: bool = False


class MetadataPlane:
    """Checkpoint/data/job metadata on a HopsFS cluster.  ``device`` is
    where a store built here runs its kernels: the card unless
    ``device="cpu"`` is asked for."""

    def __init__(self, *, n_namenodes: int = 3, n_ndb: int = 4,
                 store: Optional[MetadataStore] = None, device: Any = None):
        self.store = store or MetadataStore(n_datanodes=n_ndb, device=device)
        if self.store.table("inode").n_rows == 0:
            format_fs(self.store)
        self.cluster = NamenodeCluster(self.store, n_namenodes)
        self.client = Client(self.cluster, policy="sticky")
        for root in ("/jobs", "/ckpt", "/data"):
            self._mkdirs(root)

    # -- namespace helpers ------------------------------------------------
    def _mkdirs(self, path: str) -> None:
        self.client.execute("mkdirs", path)

    def tick(self) -> None:
        self.cluster.tick()

    # -- job ledger ---------------------------------------------------------
    def open_job(self, job: str) -> None:
        self._mkdirs(f"/jobs/{job}/ledger")
        self._mkdirs(f"/ckpt/{job}")

    def record_step(self, job: str, step: int, *, loss: float) -> None:
        self.client.execute("create", f"/jobs/{job}/ledger/step-{step:08d}")

    def last_step(self, job: str) -> Optional[int]:
        names = self.client.execute("ls", f"/jobs/{job}/ledger").value
        steps = sorted(int(n.split("-")[1]) for n in names
                       if n.startswith("step-"))
        return steps[-1] if steps else None

    # -- checkpoint manifests ------------------------------------------------
    def begin_checkpoint(self, job: str, step: int) -> str:
        base = f"/ckpt/{job}/step-{step:08d}.tmp"
        self._mkdirs(base)
        return base

    def add_shard(self, base: str, param_path: str, shard: int) -> None:
        name = param_path.replace("/", "~")
        self.client.execute("create", f"{base}/{name}.shard-{shard:05d}")

    def commit_checkpoint(self, job: str, step: int) -> None:
        """Atomic rename .tmp -> committed (the paper's subtree rename:
        one phase-3 transaction on the root, inner inodes untouched)."""
        src = f"/ckpt/{job}/step-{step:08d}.tmp"
        dst = f"/ckpt/{job}/step-{step:08d}"
        self.client.execute("rename_subtree", src, dst)

    def manifest(self, job: str, step: int) -> CheckpointManifest:
        base = f"/ckpt/{job}/step-{step:08d}"
        try:
            names = self.client.execute("ls", base).value
        except FileNotFound:
            return CheckpointManifest(job, step, {}, complete=False)
        shards: Dict[str, List[int]] = {}
        for n in names:
            if ".shard-" not in n:
                continue
            p, s = n.rsplit(".shard-", 1)
            shards.setdefault(p.replace("~", "/"), []).append(int(s))
        return CheckpointManifest(job, step, shards, complete=bool(shards))

    def latest_checkpoint(self, job: str) -> Optional[int]:
        names = self.client.execute("ls", f"/ckpt/{job}").value
        steps = [int(n.split("-")[1]) for n in names
                 if n.startswith("step-") and not n.endswith(".tmp")]
        return max(steps) if steps else None

    def gc_checkpoint(self, job: str, step: int) -> int:
        """Delete an old checkpoint tree (subtree-op protocol; batched
        post-order; crash-safe per §6.2)."""
        res = self.client.execute("delete_subtree",
                                  f"/ckpt/{job}/step-{step:08d}")
        return res.value["deleted"]

    # -- dataset registry ------------------------------------------------------
    def register_dataset(self, name: str, n_shards: int) -> None:
        self._mkdirs(f"/data/{name}")
        for k in range(n_shards):
            self.client.execute("create", f"/data/{name}/shard-{k:05d}")

    def dataset_shards(self, name: str) -> List[str]:
        return self.client.execute("ls", f"/data/{name}").value
