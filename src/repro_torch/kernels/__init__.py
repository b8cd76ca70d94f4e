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


def count_as_plain(op, plain) -> None:
    """Registers ``op``'s FLOP formula for
    ``torch.utils.flop_counter.FlopCounterMode``: what the mode counts for
    the plain version ``plain`` (called with ``op``'s arguments) on
    tensors of the same shapes.  A kernel is opaque to the mode, and its
    plain version is not what runs on the card; so a step counts alike on
    the card, on the CPU and under ``FakeTensorMode``, and counts what the
    plain version counts (flash attention: the whole ``S x S`` product,
    no causal skip).  The plain version runs once a shape on ``meta``
    tensors, each of its operations counted by the mode's own formulas
    (``flop_registry``), in a thread of its own: a formula runs inside
    the mode's dispatch, where this thread's dispatch state lets no other
    mode see an operation (and a second ``FlopCounterMode`` would reset
    the first's module tracking)."""
    import functools

    from torch.utils.flop_counter import register_flop_formula

    @functools.lru_cache(maxsize=None)
    def flops(args: tuple) -> int:
        import threading

        import torch
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry

        class Count(TorchDispatchMode):
            total = 0

            def __torch_dispatch__(self, func, types, a=(), kw=None):
                kw = kw or {}
                out = func(*a, **kw)
                formula = flop_registry.get(func._overloadpacket)
                if formula is not None:
                    self.total += formula(*a, **kw, out_val=out)
                return out

        counter, failed = Count(), []

        def run() -> None:
            try:
                with counter:
                    plain(*[torch.empty(a, device="meta")
                            if isinstance(a, torch.Size) else a
                            for a in args])
            except Exception as e:            # raised again below
                failed.append(e)

        worker = threading.Thread(target=run)
        worker.start()
        worker.join()
        if failed:
            raise failed[0]
        return counter.total

    @register_flop_formula(op)
    def formula(*args, out_shape=None, **kwargs) -> int:
        return flops(args)
