"""Device meshes over ``torch.distributed``, the JAX package's
``repro.launch.mesh``, and the process groups and rank processes under
them.

Functions, not module-level constants: importing this module touches no
device and no process group.  A mesh needs the default process group:
:func:`init_host_group` joins the launcher's (``torchrun``'s environment)
or makes a one-rank group in this process; :func:`spawn_ranks` starts
ranks itself, each in a process of its own, meeting through a file.
"""
from __future__ import annotations

import math
import multiprocessing
import os
import time
from datetime import timedelta
from pathlib import Path
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 0


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16x16 = 256 ranks per pod; 2 pods = 512 ranks multi-pod. The `pod`
    axis is the outer axis (gradient all-reduce only); `data` and `model`
    are the inner ones.  The default process group must hold exactly that
    many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if _world() != math.prod(shape):
        raise RuntimeError(
            f"the production mesh {shape} needs {math.prod(shape)} ranks; "
            f"the default process group has world size {_world()}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device_type: str = "cuda"):
    """Whatever ranks exist right now: ``(1, world_size)`` named
    ``("data", "model")`` over the default process group, one rank a
    card (or a CPU process with ``device_type="cpu"``)."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs the default process group "
                           "(init_host_group, or a rank of spawn_ranks)")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (1, _world()),
                            mesh_dim_names=("data", "model"))


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_host_group(device: torch.device) -> bool:
    """Joins the default process group unless one exists: under a
    multi-process launch (``WORLD_SIZE`` set, with ``RANK``,
    ``MASTER_ADDR`` and ``MASTER_PORT``, as ``torchrun`` sets them) the
    launcher's, else a one-rank group in this process.  NCCL on the card,
    gloo on the CPU.  Returns whether it made the group (the caller then
    destroys it)."""
    if dist.is_initialized():
        return False
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(_backend(device), init_method="env://")
    else:
        dist.init_process_group(_backend(device), store=dist.HashStore(),
                                rank=0, world_size=1)
    return True


def _rank_main(fn: Callable, rank: int, world: int, store: str,
               device_type: str, timeout: float, args: Sequence[Any]
               ) -> None:
    device = torch.device(device_type, rank) if device_type == "cuda" \
        else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(_backend(device),
                            store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=timedelta(
                                seconds=timeout))
    try:
        result = fn(rank, world, device, *args)
        torch.save(result, f"{store}.rank{rank}")
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, *args: Any, store_dir: str,
                device_type: str = "cuda", timeout: float = 120.0
                ) -> List[Any]:
    """Runs ``fn(rank, world, device, *args)`` on ``world`` ranks, one
    process each (spawned: ``fn`` and ``args`` are pickled), in one
    default process group (NCCL, one card a rank, or gloo on the CPU)
    that meets through a file under ``store_dir`` (no port).  Returns the
    ranks' return values in rank order; raises if a rank fails or the
    ranks outlast ``timeout`` seconds (a collective that waits as long
    fails its rank), and leaves no process running."""
    Path(store_dir).mkdir(parents=True, exist_ok=True)
    store = str(Path(store_dir) / f"store-{os.getpid()}-{time.time_ns()}")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, store, device_type, timeout,
                               args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        # until all are done, one has failed (the others may wait on it
        # in a collective) or the time is up
        while any(p.is_alive() for p in procs) and \
                not any(p.exitcode for p in procs) and \
                time.monotonic() < deadline:
            time.sleep(0.1)
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
        for p in alive:
            p.join(10)
    codes = [p.exitcode for p in procs]
    if alive or any(codes):
        raise RuntimeError(
            f"spawn_ranks({getattr(fn, '__name__', fn)}, {world}): exit "
            f"codes {codes}" + (f", {len(alive)} killed" if alive else ""))
    out = []
    for r in range(world):
        path = Path(f"{store}.rank{r}")
        out.append(torch.load(path, weights_only=False))
        path.unlink()
    return out
