"""The parameter tree of a configuration's model, drawn from the seed.

The names, shapes and nesting are the reference layout the program
takes (``wq [d, nh, hd]``, ``wo [nh, hd, d]``, every layer's leaves
stacked on a leading ``[L]`` axis); the benchmark draws the weights
itself, from ``--seed``, and hands the same tensors to the program and
to the reference.  Each stacked leaf is one ``normal_`` call with a
generator of its own, seeded from the run's seed and the leaf's path, so
any leaf can be drawn again alone (the training check needs the first
step's parameters after the program has updated its own in place).

Each family's file (``families/``) lists its leaves and their laws.
The laws keep the random model well conditioned, so that rounding is
not amplified layer after layer: every projection has the standard
deviation 1/sqrt(fan-in) over its true fan-in (all of ``d`` for
``wq``), so attention logits are of order one; norm scales, the biases
and RWKV-6's mixing and decay leaves are drawn around the values a
trained model holds instead of the constants they start from.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch

from perfbench.reference import families


@dataclass(frozen=True)
class Leaf:
    path: Tuple[str, ...]
    shape: Tuple[int, ...]
    mean: float
    std: float


def leaves(model: Dict[str, Any]) -> List[Leaf]:
    """Every leaf of the family's parameter tree, with its law."""
    return families.load(model).leaves(model)


def leaf_seed(seed: int, path: Tuple[str, ...]) -> int:
    """A 62-bit generator seed from the run's seed and the leaf's path."""
    h = hashlib.sha256(f"{int(seed)}/{'.'.join(path)}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 2


def draw(leaf: Leaf, seed: int, device: Any) -> torch.Tensor:
    """The leaf's fp32 values: one ``normal_`` call on ``device``."""
    g = torch.Generator(device=device).manual_seed(leaf_seed(seed, leaf.path))
    t = torch.empty(leaf.shape, dtype=torch.float32, device=device)
    return t.normal_(leaf.mean, leaf.std, generator=g)


def make_params(model: Dict[str, Any], seed: int, device: Any
                ) -> Dict[str, Any]:
    """The nested parameter tree, fp32 (the type the program serves and
    trains them in), drawn on ``device``."""
    tree: Dict[str, Any] = {}
    for leaf in leaves(model):
        node = tree
        for key in leaf.path[:-1]:
            node = node.setdefault(key, {})
        node[leaf.path[-1]] = draw(leaf, seed, device)
    return tree


def get(tree: Dict[str, Any], path: Tuple[str, ...]) -> torch.Tensor:
    for key in path:
        tree = tree[key]
    return tree
