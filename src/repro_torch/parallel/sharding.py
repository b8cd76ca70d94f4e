"""Logical-axis sharding rules (DP / FSDP / TP / EP / SP over one mesh),
the JAX package's ``repro.parallel.sharding`` over a
``torch.distributed.device_mesh.DeviceMesh``.

Every parameter and activation in the model zoo carries *logical* axis names
(("vocab", "embed"), ("batch", "seq", "embed"), ...). A :class:`MeshPolicy`
maps logical names to mesh axes:

  batch        -> ("pod", "data")     data parallelism
  heads/mlp/experts/vocab -> "model"  tensor / expert parallelism
  embed        -> "data" (fsdp=True)  ZeRO-3 parameter sharding
  kv_seq       -> "data" (seq_shard)  long-context KV caches (batch=1 cells)

:func:`logical_to_pspec` gives a :class:`PartitionSpec` (a tuple, one entry
a tensor dimension, compared entry by entry with the reference's ``P``);
:func:`named_shardings` turns it into DTensor placements, one ``Shard`` or
``Replicate`` a mesh dimension.  The models run each rank's tensors as
plain local tensors: there :func:`shard_constraint` checks the logical
axes against the mesh and returns its input, which is what the reference's
``with_sharding_constraint`` is numerically; a ``DTensor`` is redistributed
to the spec.  The MoE routes (``models.moe``) and the pipeline
(``parallel.pipeline``) do their own collectives over the mesh's groups.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

# default logical->mesh rules (single- and multi-pod; mesh axes that the
# mesh lacks are dropped by logical_to_pspec)
LOGICAL_RULES: Dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,                 # activations keep sequence unsharded (TP)
    "kv_seq": None,              # overridden by seq_shard policies
    "embed": None,               # PARAM hidden dim (fsdp shards it)
    "act_embed": None,           # ACTIVATION hidden dim: never sharded
                                 # by fsdp (fsdp is a weights-only policy)
    "heads": "model",
    "kv_heads": "model",
    "heads_flat": "model",       # rwkv: flattened H*hd projection dim
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "expert_mlp": None,
    "vocab": "model",
    "layers": None,
    "state": None,
    "conv": None,
    "frames": None,
    "cap": None,
}


@dataclass(frozen=True)
class MeshPolicy:
    """Sharding policy: logical rules + toggles.

    fsdp      — shard parameter "embed" dims over `data` (ZeRO-3).
    seq_shard — shard KV caches' "kv_seq" over `data` (long-context decode).
    rules     — overrides merged over LOGICAL_RULES.
    """
    fsdp: bool = False
    seq_shard: bool = False
    rules: Tuple[Tuple[str, Any], ...] = ()

    def resolve(self) -> Dict[str, Any]:
        r = dict(LOGICAL_RULES)
        if self.fsdp:
            r["embed"] = "data"
        if self.seq_shard:
            r["kv_seq"] = "data"
        r.update(dict(self.rules))
        return r

    def with_rules(self, **kw: Any) -> "MeshPolicy":
        return replace(self, rules=self.rules + tuple(kw.items()))


class PartitionSpec(tuple):
    """One entry a tensor dimension: None (not sharded), a mesh axis name,
    or a tuple of mesh axis names (major to minor); a tuple of one name is
    that name, as in JAX's ``PartitionSpec``."""

    def __new__(cls, *entries: Any) -> "PartitionSpec":
        return super().__new__(cls, (
            e[0] if isinstance(e, (tuple, list)) and len(e) == 1
            else tuple(e) if isinstance(e, list) else e for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _mesh_axes(mesh: Any) -> Tuple[str, ...]:
    """A ``DeviceMesh``'s dimension names (``mesh_dim_names``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise TypeError(f"{type(mesh).__name__} is not a device mesh with "
                        f"named dimensions (mesh_dim_names)")
    return tuple(names)


def mesh_shape(mesh: Any) -> Dict[str, int]:
    """``{axis name: size}``, what the reference's ``mesh.shape`` gives."""
    return dict(zip(_mesh_axes(mesh), tuple(mesh.shape)))


def is_device_mesh(mesh: Any) -> bool:
    from torch.distributed.device_mesh import DeviceMesh
    return isinstance(mesh, DeviceMesh)


def logical_to_pspec(axes: Sequence[Optional[str]], policy: MeshPolicy,
                     mesh: Any = None) -> PartitionSpec:
    """Map a tuple of logical axis names to a PartitionSpec under `policy`,
    dropping mesh axes that don't exist in `mesh` (lets one policy serve
    single-pod and multi-pod meshes); a mesh axis is used at most once."""
    rules = policy.resolve()
    present = set(_mesh_axes(mesh)) if mesh is not None else None
    out = []
    used: set = set()
    for ax in axes:
        if ax is None:
            out.append(None)
            continue
        m = rules.get(ax)
        if m is None:
            out.append(None)
            continue
        if isinstance(m, (tuple, list)):
            ms = tuple(x for x in m
                       if (present is None or x in present) and x not in used)
            used.update(ms)
            out.append(ms if ms else None)
        else:
            if (present is not None and m not in present) or m in used:
                out.append(None)
            else:
                used.add(m)
                out.append(m)
    return P(*out)


def pspec_placements(pspec: Sequence[Any], mesh: Any) -> tuple:
    """DTensor placements of ``pspec`` on ``mesh``: for each mesh
    dimension, ``Shard(d)`` if tensor dimension ``d`` is split over it,
    else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    where = {}
    for d, entry in enumerate(pspec):
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name is not None:
                where[name] = d
    return tuple(Shard(where[n]) if n in where else Replicate()
                 for n in _mesh_axes(mesh))


def shard_constraint(x: torch.Tensor, axes: Sequence[Optional[str]],
                     policy: MeshPolicy, mesh: Any = None) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` by logical axes.

    Without a mesh, the identity.  On a mesh, ``axes`` must name every
    dimension of ``x``; a plain tensor (each rank's local copy) is
    returned as it is, a ``DTensor`` is redistributed to the spec."""
    if mesh is None:
        return x
    if not is_device_mesh(mesh):
        raise TypeError(f"shard_constraint: {type(mesh).__name__} is not a "
                        f"torch.distributed DeviceMesh")
    if len(axes) != x.dim():
        raise ValueError(f"shard_constraint: {len(axes)} logical axes "
                         f"{tuple(axes)} for a {x.dim()}-d tensor")
    spec = logical_to_pspec(axes, policy, mesh)
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return x.redistribute(mesh, pspec_placements(spec, mesh))
    return x


def _is_axes(leaf: Any) -> bool:
    return isinstance(leaf, tuple) and \
        all(isinstance(a, (str, type(None))) for a in leaf)


def _map_axes(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map_axes(fn, v) for k, v in tree.items()}
    if _is_axes(tree):
        return fn(tree)
    raise TypeError(f"not a tree of logical axes: {tree!r}")


def param_pspecs(axes_tree: Any, policy: MeshPolicy,
                 mesh: Any = None) -> Any:
    """Map a tree of logical-axes tuples to a tree of PartitionSpecs."""
    return _map_axes(lambda axes: logical_to_pspec(axes, policy, mesh),
                     axes_tree)


def named_shardings(axes_tree: Any, policy: MeshPolicy, mesh: Any) -> Any:
    """The reference's ``NamedSharding`` tree as DTensor placements: a
    tree of placement tuples, one entry a mesh dimension."""
    return _map_axes(lambda axes: pspec_placements(
        logical_to_pspec(axes, policy, mesh), mesh), axes_tree)
