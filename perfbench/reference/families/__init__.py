"""The reference of each model family, one file each.

``<name>.py`` here exports ``leaves(model)`` (every leaf of the parameter
tree with the law it is drawn from), ``forward(p, tokens, model, *, mm,
remat)`` (fp32 logits ``[B, S, V]`` from an empty state) and
``forward_flops(model, B, S)`` (the model FLOPs of that forward).  A
configuration names its family's file by ``model["reference"]``, so a
new family is a new file here, found by that name.
"""
from __future__ import annotations

import importlib
from types import ModuleType
from typing import Any, Dict


def load(model: Dict[str, Any]) -> ModuleType:
    """The reference module the configuration's model names."""
    name = model["reference"]
    if not name.isidentifier():
        raise ValueError(f"bad reference family name {name!r}")
    return importlib.import_module(f"{__name__}.{name}")
