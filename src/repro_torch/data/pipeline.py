"""Tokenized data pipeline with registry-backed sharding + straggler
mitigation.

Shard assignment comes from the metadata plane's dataset registry; each
worker leases shards (lease rows in the HopsFS lease table via `create`
semantics). Straggler mitigation is backup-task style: when a worker's
heartbeat for a leased shard goes stale, the shard re-enters the work
queue and the first finisher wins (duplicate completions are idempotent —
the sample index makes re-reads deterministic).

Synthetic deterministic token streams stand in for storage I/O on this
container; the interface (shard lease -> sample batches -> complete) is the
production one.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..metaplane import MetadataPlane


def synthetic_batch(batch: int, seq: int, vocab: int, *, step: int,
                    seed: int = 0, device: Any = None
                    ) -> Dict[str, torch.Tensor]:
    """Deterministic batch: restart at step k reproduces the same data.
    Drawn on the host by numpy's generator (the JAX package's tokens, bit
    for bit), then int32 tensors on ``device`` (the card unless
    ``device="cpu"``)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed * 1_000_003 + step)
    tokens = rng.integers(0, vocab, size=(batch, seq), dtype=np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = 0
    return {"tokens": torch.from_numpy(tokens).to(dev),
            "labels": torch.from_numpy(labels).to(dev)}


@dataclass
class _ShardState:
    owner: Optional[int] = None
    last_hb: int = -1
    done: bool = False


class DataPipeline:
    """Shard scheduler over the registry with straggler re-dispatch."""

    def __init__(self, plane: MetadataPlane, dataset: str, *,
                 n_shards: int = 64, hb_timeout: int = 3):
        self.plane = plane
        self.dataset = dataset
        self.hb_timeout = hb_timeout
        self.now = 0
        try:
            shards = plane.dataset_shards(dataset)
        except Exception:
            shards = []
        if not shards:
            plane.register_dataset(dataset, n_shards)
            shards = plane.dataset_shards(dataset)
        self.state: Dict[str, _ShardState] = {s: _ShardState()
                                              for s in shards}
        self.duplicate_completions = 0

    # -- scheduling -------------------------------------------------------
    def tick(self) -> None:
        self.now += 1

    def lease(self, worker: int) -> Optional[str]:
        # fresh shards first, then stale (straggler) re-dispatch
        for name, st in self.state.items():
            if st.done or st.owner is not None:
                continue
            st.owner, st.last_hb = worker, self.now
            return name
        for name, st in self.state.items():
            if st.done:
                continue
            if st.owner is not None and \
                    self.now - st.last_hb > self.hb_timeout:
                st.owner, st.last_hb = worker, self.now  # backup task
                return name
        return None

    def heartbeat(self, worker: int, shard: str) -> None:
        st = self.state[shard]
        if st.owner == worker:
            st.last_hb = self.now

    def complete(self, worker: int, shard: str) -> bool:
        st = self.state[shard]
        if st.done:
            self.duplicate_completions += 1
            return False
        st.done = True
        return True

    def pending(self) -> int:
        return sum(1 for st in self.state.values() if not st.done)

    # -- reading -----------------------------------------------------------
    def read(self, shard: str, *, batch: int, seq: int, vocab: int,
             step: int, device: Any = None) -> Dict[str, torch.Tensor]:
        seed = int(hashlib.md5(shard.encode()).hexdigest()[:8], 16)
        return synthetic_batch(batch, seq, vocab, step=step, seed=seed,
                               device=device)
