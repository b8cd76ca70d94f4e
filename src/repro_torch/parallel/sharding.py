"""Logical-axis sharding, as far as one card needs it.

The models annotate every activation with logical axis names
(``("batch", "seq", "act_embed")``); in the JAX package a
:class:`MeshPolicy` maps those names to the axes of a device mesh.  On one
card there is no mesh: :func:`shard_constraint` returns its input
unchanged when ``mesh is None``.  Sharding over several cards
(``torch.distributed`` device meshes) is not ported yet: a mesh raises
``NotImplementedError`` naming ROADMAP.md queue 1 item 3.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import torch


@dataclass(frozen=True)
class MeshPolicy:
    """Sharding policy, the JAX package's fields.

    fsdp      — shard parameter "embed" dims over `data` (ZeRO-3).
    seq_shard — shard KV caches' "kv_seq" over `data` (long-context decode).
    rules     — overrides of the logical -> mesh axis rules.
    """
    fsdp: bool = False
    seq_shard: bool = False
    rules: Tuple[Tuple[str, Any], ...] = ()


def shard_constraint(x: torch.Tensor, axes: Sequence[Optional[str]],
                     policy: MeshPolicy, mesh: Any = None) -> torch.Tensor:
    """The identity on one card (``mesh is None``)."""
    if mesh is not None:
        raise NotImplementedError(
            "sharding over a device mesh is not ported yet (ROADMAP.md "
            "queue 1 item 3, multi-device)")
    return x
