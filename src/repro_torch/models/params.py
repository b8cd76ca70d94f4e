"""Parameter trees: shapes + logical axes + initialization.

Models declare a nested dict of :class:`ParamSpec` (shape, logical axes,
init law), with the JAX package's names and layout, so one spec tree gives

  * ``init_params``       — tensors on a device, drawn from an explicit
                            ``torch.Generator``
  * ``params_from_numpy`` — the JAX package's parameters, carried across
                            as numpy arrays (the tests' weights carry)
  * ``shard_params``      — a full tree cut to one rank's slices of a
                            device mesh, by a tree of PartitionSpecs;
                            ``gather_params`` the way back
  * ``abstract_params``   — tensors on the ``meta`` device: shapes and
                            dtypes, no memory (``jax.ShapeDtypeStruct``)
  * ``axes_tree``         — the tree of logical axes
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"        # normal | zeros | ones | scaled
    scale: float = 1.0

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a nested dict (a ParamSpec, a tensor
    or an array is a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a nested dict, in its keys' insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def init_params(specs: Any, generator: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device: Union[str, torch.device, None] = None) -> Any:
    """Materialise a spec tree on ``device`` (the card unless asked for
    the CPU).  ``generator`` must live on that device; the same seed gives
    the same tensors there (not the JAX package's numbers: the tests carry
    weights across with :func:`params_from_numpy`)."""
    dev = resolve_device(device)

    def make(s: ParamSpec) -> torch.Tensor:
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dtype, device=dev)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dtype, device=dev)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        std = s.scale / math.sqrt(max(1, fan_in))
        w = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return (w.mul_(std)).to(dtype)

    return tree_map(make, specs)


def params_from_numpy(tree: Any, device: Union[str, torch.device, None]
                      = None) -> Any:
    """A nested dict of numpy arrays (the JAX package's parameters or
    caches through ``np.asarray``) -> the same tree of tensors on
    ``device``, dtypes kept (bf16 arrives as ml_dtypes' bfloat16)."""
    dev = resolve_device(device)

    def conv(a: Any) -> torch.Tensor:
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(np.ascontiguousarray(a.astype(np.float32)))
            return t.to(dev, torch.bfloat16)
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    return tree_map(conv, tree)


def _rank_slice(a: Any, spec: Tuple[Any, ...], coord: dict,
                sizes: dict) -> Any:
    """The block of ``a`` that the rank at mesh coordinates ``coord``
    holds under ``spec`` (a dimension split over several mesh axes is cut
    with the first of them major, as JAX lays out a PartitionSpec)."""
    if len(spec) > a.ndim:
        raise ValueError(f"spec {spec} for a {a.ndim}-d leaf")
    index = []
    for dim, entry in enumerate(spec):
        names = () if entry is None else \
            (entry if isinstance(entry, tuple) else (entry,))
        n, i = 1, 0
        for name in names:
            n, i = n * sizes[name], i * sizes[name] + coord[name]
        if a.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(a.shape)} does not "
                             f"split {n} ways ({spec})")
        step = a.shape[dim] // n
        index.append(slice(i * step, (i + 1) * step))
    return a[tuple(index)]


def shard_params(tree: Any, pspecs: Any, mesh: Any,
                 device: Union[str, torch.device, None] = None) -> Any:
    """This rank's slices of a full parameter tree (numpy arrays or
    tensors) on ``mesh``: each leaf cut by its PartitionSpec in ``pspecs``
    (a tree of the same keys, e.g. ``parallel.sharding.storage_pspecs``),
    then carried to ``device`` as
    :func:`params_from_numpy` does."""
    names = tuple(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    coord, sizes = dict(zip(names, coord)), dict(zip(names, mesh.shape))
    dev = resolve_device(device)

    def cut(a: Any, spec: Tuple[Any, ...]) -> torch.Tensor:
        if torch.is_tensor(a):
            return _rank_slice(a, spec, coord, sizes).to(dev, copy=True)
        return params_from_numpy(_rank_slice(np.asarray(a), spec, coord,
                                             sizes), dev)

    def walk(t: Any, s: Any) -> Any:
        if isinstance(t, dict):
            return {k: walk(v, s[k]) for k, v in t.items()}
        return cut(t, s)

    return walk(tree, pspecs)


def gather_params(tree: Any, pspecs: Any, mesh: Any) -> Any:
    """The inverse of :func:`shard_params`: every rank's slices gathered
    into the full tree on every rank (a collective over the groups of the
    mesh axes that split a leaf; a leaf split over none is returned as it
    is)."""
    from ..parallel.sharding import all_gather_list

    def full(t: torch.Tensor, spec: Tuple[Any, ...]) -> torch.Tensor:
        for dim, entry in enumerate(spec):
            names = () if entry is None else \
                (entry if isinstance(entry, tuple) else (entry,))
            for name in reversed(names):          # the minor axis first
                t = torch.cat(all_gather_list(t, mesh.get_group(name)),
                              dim)
        return t

    def walk(t: Any, s: Any) -> Any:
        if isinstance(t, dict):
            return {k: walk(v, s[k]) for k, v in t.items()}
        return full(t, s)

    return walk(tree, pspecs)


def abstract_params(specs: Any, dtype: torch.dtype = torch.float32) -> Any:
    return tree_map(lambda s: torch.empty(s.shape, dtype=dtype,
                                          device="meta"), specs)


def axes_tree(specs: Any) -> Any:
    return tree_map(lambda s: s.axes, specs)


def count_params(specs: Any) -> int:
    return sum(int(np.prod(s.shape)) for s in tree_leaves(specs))


def param_bytes(specs: Any, bytes_per_param: int = 4) -> int:
    return count_params(specs) * bytes_per_param
