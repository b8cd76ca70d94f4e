"""Hand-written CUDA kernels: the metadata plane's integer hot paths
(``phash``, ``pkval``, ``hintchain``, ``treeagg``) and the model stack's
float ones (``flash_attention``, ``mamba2_ssd``, ``rwkv6_scan``,
``moe_gmm``).

Each family package holds ``kernel.py`` (the binding of the CUDA kernel in
``csrc/``), ``ref.py`` (the plain PyTorch version of the same function) and
``ops.py`` (host-facing wrappers: dtype and device handling, then the
kernel for a CUDA tensor or the plain version for a CPU tensor).

:data:`LAUNCHES` counts the CUDA launches of each kernel — only the
kernel bindings add to it, one per launch — so a run can show that its
path really went through the kernels on the card.
"""
from __future__ import annotations

from typing import Dict

#: CUDA launches per kernel since the last :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"phash": 0, "phash_chain": 0, "pkval": 0,
                            "hintchain": 0, "treeagg": 0,
                            "flash_attention": 0, "ssd": 0, "wkv6": 0,
                            "gmm": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)
