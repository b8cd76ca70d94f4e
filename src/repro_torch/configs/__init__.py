"""Architecture registry: ``get_config(name)`` + ``ARCHS`` listing.

Each module defines CONFIG (the full published architecture) and
``smoke_config()`` (a reduced same-family config for CPU tests).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from ..models.config import ModelConfig

ARCHS: List[str] = [
    "qwen2_vl_7b",
    "qwen3_moe_30b_a3b",
    "mixtral_8x22b",
    "command_r_plus_104b",
    "gemma3_12b",
    "nemotron_4_340b",
    "qwen1_5_4b",
    "zamba2_2_7b",
    "rwkv6_3b",
    "seamless_m4t_medium",
]

# input shapes assigned to the LM pool (seq_len, global_batch, kind)
SHAPES: Dict[str, Dict] = {
    "train_4k": {"seq": 4096, "batch": 256, "kind": "train"},
    "prefill_32k": {"seq": 32768, "batch": 32, "kind": "prefill"},
    "decode_32k": {"seq": 32768, "batch": 128, "kind": "decode"},
    "long_500k": {"seq": 524288, "batch": 1, "kind": "decode"},
}

#: archs that can run the sub-quadratic long_500k cell (SSM / hybrid /
#: windowed attention); pure full-attention archs skip it (see DESIGN.md
#: §3.3)
LONG_CONTEXT_OK = {"rwkv6_3b", "zamba2_2_7b", "mixtral_8x22b", "gemma3_12b"}


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f".{name}", __package__)
    return mod.CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f".{name}", __package__)
    return mod.smoke_config()


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells, honoring the long-context skip."""
    out = []
    for a in ARCHS:
        for s in SHAPES:
            skip = (s == "long_500k" and a not in LONG_CONTEXT_OK)
            if include_skipped or not skip:
                out.append((a, s, skip))
    return out
