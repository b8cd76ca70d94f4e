"""Logical-axis sharding rules (DP / FSDP / TP / EP / SP over one mesh),
the JAX package's ``repro.parallel.sharding`` over a
``torch.distributed.device_mesh.DeviceMesh``, and the port's storage
layout and region collectives on such a mesh.

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
``Replicate`` a mesh dimension.

**Storage.**  Each rank holds every leaf as :func:`storage_pspecs` cuts it:
the reference's ``param_pspecs`` less the entries whose dimension does not
divide (GSPMD pads those; the port keeps that leaf whole on that axis).
The models compute on plain local tensors (:func:`shard_constraint`
returns a local tensor as it is and redistributes a ``DTensor``); where the
reference's constraints move data, the models call the collectives below,
under one gradient convention: every rank of the `model` group computes
the same loss, so a rank's gradient of a tensor that all of them hold
alike is already whole.

  * :class:`_FromReplicated` — into a region that splits its work over the
    group: the identity; the gradient is summed (Megatron's ``f``).
  * :func:`reduce_over` — out of it, the partial sums added: an
    all-reduce; the gradient passes as it is (Megatron's ``g``).
  * :class:`_ToReplicated` — out of the MoE routes, whose exchange sends
    each rank's whole gradient back: each of ``n`` counts ``1/n``.
  * :func:`gather_leaf` — a stored shard gathered for use.  Over `model`,
    for compute every model rank repeats: the backward takes this rank's
    slice of the (whole) gradient.  Over `data` (FSDP), where the ranks
    hold different rows of the batch: the backward reduce-scatters the sum
    (in bf16 under :func:`grad_wire`).  Gathered leaves that autograd
    saves are saved as their shard and gathered again when the backward
    reads them (:func:`regather_saved`).
"""
from __future__ import annotations

import math
import weakref
from contextlib import contextmanager
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


# ---------------------------------------------------------------------------
# the port's storage layout
# ---------------------------------------------------------------------------


def _names(entry: Any) -> Tuple[str, ...]:
    """The mesh axes of one PartitionSpec entry, major to minor."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def storage_pspec(shape: Sequence[int], axes: Sequence[Optional[str]],
                  policy: MeshPolicy, mesh: Any) -> PartitionSpec:
    """How the port stores a leaf of ``shape`` and logical ``axes``:
    ``logical_to_pspec``, less each entry whose dimension does not divide
    the product of its mesh axes (that dimension stays whole)."""
    spec = logical_to_pspec(axes, policy, mesh)
    sizes = mesh_shape(mesh)
    return P(*(e if n % math.prod(sizes[a] for a in _names(e)) == 0
               else None for n, e in zip(shape, spec)))


def storage_pspecs(spec_tree: Any, policy: MeshPolicy, mesh: Any) -> Any:
    """:func:`storage_pspec` of every leaf of a tree of ``ParamSpec``s
    (anything with ``shape`` and ``axes``)."""
    if isinstance(spec_tree, dict):
        return {k: storage_pspecs(v, policy, mesh)
                for k, v in spec_tree.items()}
    return storage_pspec(spec_tree.shape, spec_tree.axes, policy, mesh)


def opt_pspecs(pspecs: Any) -> Dict[str, Any]:
    """AdamW's state stored as its parameters (``opt_axes_tree``)."""
    return {"mu": pspecs, "nu": pspecs, "step": P()}


def local_shape(shape: Sequence[int], pspec: Sequence[Any],
                mesh: Any) -> Tuple[int, ...]:
    """A leaf's shape on one rank under ``pspec``."""
    sizes = mesh_shape(mesh)
    spec = tuple(pspec) + (None,) * (len(shape) - len(pspec))
    return tuple(n // math.prod(sizes[a] for a in _names(e))
                 for n, e in zip(shape, spec))


def batch_mesh_axes(policy: MeshPolicy, mesh: Any) -> Tuple[str, ...]:
    """The mesh axes the batch's rows are split over."""
    return _names(logical_to_pspec(("batch",), policy, mesh)[0])


def model_part(mesh: Any) -> Tuple[Any, int, int]:
    """``(group, size, index)`` of this rank's `model` group; ``(None, 1,
    0)`` without a mesh or where the axis holds one rank."""
    if mesh is None or "model" not in _mesh_axes(mesh):
        return None, 1, 0
    group = mesh.get_group("model")
    if group.size() == 1:
        return None, 1, 0
    import torch.distributed as dist
    return group, group.size(), dist.get_rank(group)


#: a KV cache leaf's logical axes (``models.lm``; zamba2's shared block
#: has None for `layers`, which maps to no mesh axis either way)
KV_CACHE_AXES = ("layers", "batch", "kv_seq", "kv_heads", None)


def seq_part(policy: MeshPolicy, mesh: Any) -> Tuple[Any, int, int]:
    """``(group, size, index)`` of the mesh axis that a KV cache's
    `kv_seq` maps to under ``policy`` (`data` under ``seq_shard``, where
    the batch leaves it free); ``(None, 1, 0)`` without a mesh, where it
    maps to none or the axis holds one rank.  Rank ``index`` of the group
    holds the cache's rows ``[index * S_loc, (index + 1) * S_loc)``: the
    caller stores the cache by :func:`storage_pspecs`, whose length must
    then divide the axis (a length that does not stays whole there, and
    this split would misread it)."""
    if mesh is None:
        return None, 1, 0
    names = _names(logical_to_pspec(KV_CACHE_AXES, policy, mesh)[2])
    if not names:
        return None, 1, 0
    if len(names) > 1:
        raise NotImplementedError(f"kv_seq over {names}: one mesh axis")
    group = mesh.get_group(names[0])
    if group.size() == 1:
        return None, 1, 0
    import torch.distributed as dist
    return group, group.size(), dist.get_rank(group)


# ---------------------------------------------------------------------------
# region collectives
# ---------------------------------------------------------------------------


def _all_gather_single():
    import torch.distributed as dist
    return getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor


def all_gather_dim(t: torch.Tensor, dim: int, group: Any) -> torch.Tensor:
    """Every rank's ``t`` of ``group`` concatenated along ``dim``, in the
    group's rank order (no autograd)."""
    n = group.size()
    src = (t.movedim(dim, 0) if dim else t).contiguous()
    buf = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    _all_gather_single()(buf, src, group=group)
    return buf.movedim(0, dim).contiguous() if dim else buf


def all_gather_list(t: torch.Tensor, group: Any) -> list:
    """Every rank's ``t`` of ``group``, in the group's rank order: one
    ``all_gather`` into a list (no autograd; ``launch.dryrun.
    StepRecorder(fill=True)`` writes this rank's tensor into each slot)."""
    import torch.distributed as dist
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(group.size())]
    dist.all_gather(parts, t, group=group)
    return parts


def reduce_scatter_dim(t: torch.Tensor, dim: int, group: Any
                       ) -> torch.Tensor:
    """The sum of every rank's ``t`` over ``group``, this rank's block of
    it along ``dim`` (no autograd)."""
    import torch.distributed as dist
    n = group.size()
    src = (t.movedim(dim, 0) if dim else t).contiguous()
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    (getattr(dist, "reduce_scatter_single", None) or
     dist.reduce_scatter_tensor)(out, src, group=group)
    return out.movedim(0, dim) if dim else out


def _own_block(t: torch.Tensor, dim: int, group: Any) -> torch.Tensor:
    import torch.distributed as dist
    k = t.shape[dim] // group.size()
    return t.narrow(dim, dist.get_rank(group) * k, k)


class _FromReplicated(torch.autograd.Function):
    """Into a region from a tensor every rank of ``group`` holds alike:
    the identity; its gradient is summed over the group."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ToReplicated(torch.autograd.Function):
    """Out of a region to a tensor every rank holds alike, where the
    region's exchange sends each rank's gradient back to its source (the
    MoE routes): the identity; each of the ``n`` ranks' identical losses
    counts 1/n of its gradient."""

    @staticmethod
    def forward(ctx, t, n):
        ctx.n = n
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _ReduceOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed as dist
        t = t.contiguous().clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        return g, None


def from_replicated(t: torch.Tensor, group: Any) -> torch.Tensor:
    """:class:`_FromReplicated`, the identity without a group."""
    return t if group is None else _FromReplicated.apply(t, group)


def reduce_over(t: torch.Tensor, group: Any) -> torch.Tensor:
    """The sum over ``group`` of the ranks' partial ``t``: an all-reduce
    whose backward passes the (whole) gradient as it is; ``t`` itself
    without a group."""
    return t if group is None else _ReduceOver.apply(t, group)


#: the dtype a data gather's backward reduce-scatters in (None: the
#: gradient's own, upcast to the shard's dtype); :func:`grad_wire`
_WIRE: list = [None]


@contextmanager
def grad_wire(dtype: Optional[torch.dtype]):
    """Gradients reduce-scattered by :func:`gather_leaf`'s backward
    travel in ``dtype`` inside this block (bf16 under ``grad_compress``,
    "bf16 on the wire")."""
    _WIRE.append(dtype)
    try:
        yield
    finally:
        _WIRE.pop()


@dataclass(frozen=True)
class Gather:
    """One leaf's gathers on use: ``steps`` of ``(dim, group, summed)``
    in order (``summed``: the ranks of ``group`` hold different rows, so
    the backward reduce-scatters; else it takes this rank's block), the
    shard cast to ``dtype`` first (None: kept)."""
    steps: Tuple[Tuple[int, Any, bool], ...]
    dtype: Optional[torch.dtype] = None


class _LiveBytes:
    """The bytes of gathered leaves alive at once (their storages, from
    the gather until freed) and their peak since :meth:`reset`."""

    def __init__(self) -> None:
        self.live = self.peak = 0

    def reset(self) -> None:
        self.peak = self.live

    def add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n


#: every gathered leaf's storage, forward and backward (the dry run's
#: FSDP check reads its peak)
GATHERED = _LiveBytes()


def _gather_steps(t: torch.Tensor, plan: Gather) -> torch.Tensor:
    out = t if plan.dtype is None else t.to(plan.dtype)
    for dim, group, _ in plan.steps:
        out = all_gather_dim(out, dim, group)
    GATHERED.add(out)
    return out


class _GatherLeaf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, plan, wire):
        ctx.plan, ctx.dtype, ctx.wire = plan, t.dtype, wire
        return _gather_steps(t, plan)

    @staticmethod
    def backward(ctx, g):
        for dim, group, summed in reversed(ctx.plan.steps):
            if summed:
                g = reduce_scatter_dim(g.to(ctx.wire or ctx.dtype), dim,
                                       group)
            else:
                g = _own_block(g, dim, group)
        return g.to(ctx.dtype), None, None


#: the open :func:`regather_saved` scopes' registries (innermost last)
_SCOPES: list = []


def gather_leaf(t: torch.Tensor, plan: Optional[Gather]) -> torch.Tensor:
    """``t`` (a stored shard) gathered by ``plan``; ``t`` as it is for no
    plan.  Inside :func:`regather_saved` the result is registered, so
    that autograd saves it as its shard."""
    if plan is None or not plan.steps:
        return t
    out = _GatherLeaf.apply(t, plan, _WIRE[-1])
    if _SCOPES and out.requires_grad:
        st = out.untyped_storage()
        _SCOPES[-1][st._cdata] = (weakref.ref(st), t, plan)
    return out


def gather_tree(tree: Any, plans: Any) -> Any:
    """:func:`gather_leaf` over a tree and its tree of plans."""
    if isinstance(tree, dict):
        return {k: gather_tree(v, plans[k]) for k, v in tree.items()}
    return gather_leaf(tree, plans)


class _Saved:
    """A saved view of a gathered leaf: its shard, plan and view."""
    __slots__ = ("shard", "plan", "view", "cache")

    def __init__(self, shard, plan, view, cache):
        self.shard, self.plan, self.view, self.cache = shard, plan, view, \
            cache


@contextmanager
def regather_saved(active: bool = True):
    """Inside this block, a gathered leaf (:func:`gather_leaf`) that an
    operation saves for the backward is saved as its shard and gathered
    again when the backward reads it, once while that copy lives; every
    other saved tensor is kept as autograd keeps it.  A checkpointed
    region inside saves nothing of its own (its recompute gathers)."""
    if not active:
        yield
        return
    live: Dict[int, Any] = {}
    again: Dict[int, Any] = {}

    def pack(t):
        st = t.untyped_storage()
        hit = live.get(st._cdata)
        if hit is None or hit[0]() is not st:
            return t
        return _Saved(hit[1], hit[2], (t.size(), t.stride(),
                                       t.storage_offset()), again)

    def unpack(x):
        if not isinstance(x, _Saved):
            return x
        key = (id(x.shard), x.plan)
        ref = x.cache.get(key)
        full = ref() if ref is not None else None
        if full is None:
            with torch.no_grad():
                full = _gather_steps(x.shard, x.plan)
            x.cache[key] = weakref.ref(full)
        return full.as_strided(*x.view)

    _SCOPES.append(live)
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
            yield
    finally:
        _SCOPES.pop()
