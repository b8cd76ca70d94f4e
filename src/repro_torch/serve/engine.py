"""Batched serving engine: continuous-batching scheduler over the
prefill/decode steps, the JAX package's ``repro.serve.engine`` in PyTorch.

Requests enter a queue; the engine packs up to `max_batch` active sequences
into one shared KV cache (slot-per-request), prefilling new requests one
token at a time through the decode step and decoding all active slots
together.  The scheduling is the reference's exactly, its faults included:
every step writes every slot's cache (a prefill feeds zeros to the other
slots), and a step decodes every slot at the largest position (ROADMAP.md
queue 3).  Runs on the card unless ``device="cpu"`` is asked for.

On a mesh, ``params`` are this rank's shards
(``parallel.sharding.storage_pspecs``), the cache is held as its axes
split it (the kv heads over `model` where they divide), every rank serves
every slot, and the last
position's logits, this rank's slice of the vocabulary, are gathered over
`model` before the ``argmax``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..models import forward, init_cache_specs
from ..models.config import ModelConfig
from ..models.params import tree_map
from ..parallel.sharding import (MeshPolicy, all_gather_dim, local_shape,
                                 model_part, storage_pspecs)


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # [S] int32
    max_new: int = 8
    generated: List[int] = field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: Any, *,
                 max_batch: int = 4, max_seq: int = 128,
                 policy: MeshPolicy = MeshPolicy(), mesh=None,
                 device: Union[str, torch.device, None] = None):
        self.cfg = cfg
        self.params = params
        self.policy = policy
        self.mesh = mesh
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.max_seq = max_seq
        specs = init_cache_specs(cfg, max_batch, max_seq)
        shapes = tree_map(lambda s: s.shape, specs)
        if mesh is not None:
            # every slot on every rank; the KV sequence whole
            whole = policy.with_rules(batch=None, kv_seq=None)
            shapes = tree_map(lambda s: local_shape(
                s.shape, storage_pspecs(s, whole, mesh), mesh), specs)
        # the reference's cache dtypes: bf16 for rank >= 3, fp32 otherwise
        self.cache = tree_map(lambda shape: torch.zeros(
            shape, dtype=torch.bfloat16 if len(shape) >= 3
            else torch.float32, device=self.device), shapes)
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.positions = np.zeros(max_batch, np.int32)
        self.queue: List[Request] = []
        self.completed: List[Request] = []

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def _decode_fn(self, params, tokens, cache, index):
        # the cache is whole along the sequence: no kv_seq split
        logits, new_cache = forward(params, {"tokens": tokens},
                                    cfg=self.cfg,
                                    policy=self.policy.with_rules(
                                        kv_seq=None),
                                    mesh=self.mesh, cache=cache,
                                    cache_index=index, device=self.device)
        last = logits[:, -1]
        if last.shape[-1] < self.cfg.vocab_size:
            last = all_gather_dim(last, 1, model_part(self.mesh)[0])
        return torch.argmax(last, dim=-1), new_cache

    def _tokens(self, tokens: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(tokens).to(self.device)

    def _prefill(self, slot: int, req: Request) -> None:
        """Prefill one request token-by-token into its slot (slot-local
        decode steps, as the reference does)."""
        for t, tok in enumerate(req.prompt):
            tokens = np.zeros((self.max_batch, 1), np.int32)
            tokens[slot, 0] = tok
            _, self.cache = self._decode_fn(self.params, self._tokens(tokens),
                                         self.cache, t)
        self.positions[slot] = len(req.prompt)

    # ------------------------------------------------------------------
    def step(self) -> None:
        """One engine iteration: admit + decode all active slots."""
        while self.queue and self._free_slot() is not None:
            slot = self._free_slot()
            req = self.queue.pop(0)
            self.slots[slot] = req
            self._prefill(slot, req)
        active = [(i, r) for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return
        tokens = np.zeros((self.max_batch, 1), np.int32)
        for i, r in active:
            last = r.generated[-1] if r.generated else int(r.prompt[-1])
            tokens[i, 0] = last
        index = int(max(self.positions[i] for i, _ in active))
        nxt, self.cache = self._decode_fn(self.params, self._tokens(tokens),
                                       self.cache, index)
        nxt = nxt.cpu().numpy()
        for i, r in active:
            r.generated.append(int(nxt[i]))
            self.positions[i] += 1
            if len(r.generated) >= r.max_new or \
                    self.positions[i] >= self.max_seq - 1:
                r.done = True
                self.completed.append(r)
                self.slots[i] = None

    def run(self, max_iters: int = 64) -> List[Request]:
        for _ in range(max_iters):
            if not self.queue and all(s is None for s in self.slots):
                break
            self.step()
        return self.completed
