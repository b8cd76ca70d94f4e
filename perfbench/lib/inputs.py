"""Inputs drawn from the run's seed, and the program's view of a
configuration.

Token ids are drawn on the device, one generator a batch seeded from the
run's seed and the batch's name, so any batch can be drawn again alone
(the reference gets the same ids).  The program is handed only these
inputs and the benchmark's weights.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Any, Dict, Iterable, List

import torch

from perfbench.reference import layout


def tokens(seed: int, name: str, shape, vocab: int, device: Any
           ) -> torch.Tensor:
    """int32 ids, uniform over the vocabulary."""
    g = torch.Generator(device=device).manual_seed(
        layout.leaf_seed(seed, ("tokens", name)))
    return torch.randint(0, vocab, tuple(shape), generator=g, device=device,
                         dtype=torch.int32)


def host_rng(seed: int, name: str) -> random.Random:
    """A host generator for choices (which calls and rows the check
    samples)."""
    return random.Random(layout.leaf_seed(seed, ("host", name)))


def program_config(model: Dict[str, Any], **runtime: Any):
    """The program's ``ModelConfig`` for a configuration file's model:
    the fields it has, plus runtime knobs (``remat``)."""
    from repro_torch.models.config import ModelConfig
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in model.items() if k in names}
    return ModelConfig(**kw, **runtime)


def check_layout(cfg, params: Dict[str, Any]) -> None:
    """The benchmark's tree has the program's leaves and shapes."""
    from repro_torch.models import param_specs

    def paths(t, pre=()) -> Iterable:
        for k, v in t.items():
            if isinstance(v, dict):
                yield from paths(v, pre + (k,))
            else:
                yield pre + (k,), v

    want = {p: tuple(s.shape) for p, s in paths(param_specs(cfg))}
    have = {p: tuple(t.shape) for p, t in paths(params)}
    if want != have:
        diff = sorted(set(want.items()) ^ set(have.items()))[:6]
        raise ValueError(f"the benchmark's parameter layout is not the "
                         f"program's: {diff}")


def free(*trees: Any) -> None:
    """Drops the tensors of the trees given (dicts or lists) and returns
    their memory to the device."""
    for t in trees:
        t.clear()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def sync(device: Any) -> None:
    """Waits for the device's queued work (nothing to wait for on the
    CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def pick(rng: random.Random, n: int, k: int) -> List[int]:
    return sorted(rng.sample(range(n), min(k, n)))
