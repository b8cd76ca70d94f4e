"""End-to-end training driver, the JAX package's ``repro.launch.train``.

Wires together: config registry -> data pipeline (registry-backed shards)
-> train step -> checkpoint manager (manifests in the metadata plane)
-> fleet runtime (heartbeats, failover, elastic re-mesh).

Runs on the card unless ``--device cpu`` is given (without CUDA it
raises), on ``make_host_mesh()`` as the reference does: under a
multi-process launch (``torchrun``, ``WORLD_SIZE`` set) one rank a card
(``LOCAL_RANK``), every rank on the same batch, each holding its shards
of the parameters and moments as ``parallel.sharding.storage_pspecs``
lays them out under the reference's policy (heads, MLP, vocabulary and
experts over the `model` ranks where they divide); otherwise one rank.
Rank 0 prints and writes the checkpoints (the whole tree, gathered from
every rank first: the files are the reference's); every rank resumes
from them.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1_5_4b \\
      --smoke --steps 20 --batch 8 --seq 64
  torchrun --nproc-per-node 4 -m repro_torch.launch.train ...

``--resume`` restores the latest committed checkpoint of ``--ckpt-dir``;
a new process's metadata plane is new, so the committed step directories
are first entered into it (``CheckpointManager.register_committed``).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..ckpt import CheckpointManager
from ..configs import ARCHS, get_config, get_smoke_config
from ..data import DataPipeline, synthetic_batch
from ..device import resolve_device
from ..metaplane import MetadataPlane
from ..models import gather_params, init_params, param_specs, shard_params
from ..parallel.sharding import (MeshPolicy, mesh_shape, opt_pspecs,
                                 storage_pspecs)
from ..runtime import FleetRuntime
from ..train.optimizer import OptConfig, adamw_init
from ..train.step import make_train_step
from .mesh import init_host_group, make_host_mesh


def _init_sharded(specs, pspecs, gen, mesh, dev):
    """``init_params``'s tensors, each leaf cut to this rank's slice as
    soon as it is drawn (the same numbers as one ``init_params`` call)."""
    if isinstance(specs, dict):
        return {k: _init_sharded(v, pspecs[k], gen, mesh, dev)
                for k, v in specs.items()}
    return shard_params(init_params(specs, gen, device=dev), pspecs, mesh,
                        dev)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="qwen1_5_4b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro-ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-worker-at", type=int, default=-1,
                    help="inject a worker failure at this step (demo)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda" and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    owns_group = init_host_group(dev)
    try:
        _train(args, dev)
    finally:
        if owns_group:
            dist.destroy_process_group()


def _train(args: argparse.Namespace, dev: torch.device) -> None:
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    mesh = make_host_mesh(dev.type)
    policy = MeshPolicy()
    M = mesh_shape(mesh)["model"]
    if cfg.n_experts and cfg.n_experts % M:
        # the experts do not divide the ranks: the tensor-parallel route
        # splits each expert's hidden units (launch.inputs.cell_policy)
        policy = policy.with_rules(experts=None, expert_mlp="model")
    job = f"{args.arch}-train"
    lead = dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)

    plane = MetadataPlane(device=dev)
    fleet = FleetRuntime(plane, n_workers=4,
                         model_axis=mesh_shape(mesh)["model"])
    pipeline = DataPipeline(plane, f"{args.arch}-ds", n_shards=16)
    ckpt = CheckpointManager(args.ckpt_dir, plane, job, keep=2, device=dev)

    specs = param_specs(cfg)
    pspecs = storage_pspecs(specs, policy, mesh)
    o_pspecs = opt_pspecs(pspecs)
    params = _init_sharded(specs, pspecs,
                           torch.Generator(device=dev).manual_seed(0), mesh,
                           dev)
    opt_state = adamw_init(params)
    start = 0
    if args.resume:
        ckpt.register_committed()
        restored = ckpt.restore_latest()
        if restored is not None:
            start, p_full, o_full = restored
            params = shard_params(p_full, pspecs, mesh, dev)
            opt_state = shard_params(o_full, o_pspecs, mesh, dev)
            del p_full, o_full
            say(f"resumed from step {start}")

    opt = OptConfig(total_steps=max(args.steps, 1))
    step_fn = make_train_step(cfg, policy, mesh, opt=opt,
                              microbatches=args.microbatches, device=dev)

    t0 = time.time()
    for step in range(start, args.steps):
        fleet.tick()
        plane.tick()
        if step == args.fail_worker_at:
            fleet.fail_worker(0)
            say(f"[step {step}] injected worker-0 failure; "
                f"leader={fleet.leader()} mesh={fleet.maybe_remesh()}")
        shard = pipeline.lease(worker=fleet.leader() or 0)
        if shard is not None:
            pipeline.heartbeat(fleet.leader() or 0, shard)
        batch = synthetic_batch(args.batch, args.seq, cfg.vocab_size,
                                step=step, device=dev)
        if cfg.family == "vlm":
            batch["patch_embeds"] = torch.ones(
                (args.batch, cfg.n_patches, cfg.d_model),
                dtype=torch.bfloat16, device=dev)
            batch["positions"] = torch.zeros((args.batch, args.seq, 3),
                                             dtype=torch.int32, device=dev)
        if cfg.family == "encdec":
            batch["frames"] = torch.ones(
                (args.batch, cfg.n_patches, cfg.d_model),
                dtype=torch.bfloat16, device=dev)
        params, opt_state, loss = step_fn(params, opt_state, batch)
        if shard is not None:
            pipeline.complete(fleet.leader() or 0, shard)
        plane.record_step(job, step, loss=float(loss))
        if step % 5 == 0 or step == args.steps - 1:
            say(f"step {step:4d} loss {float(loss):8.4f} "
                f"({time.time() - t0:5.1f}s)")
        if (step + 1) % args.ckpt_every == 0:
            # every rank takes part in gathering the shards
            full = (gather_params(params, pspecs, mesh),
                    gather_params(opt_state, o_pspecs, mesh))
            if lead:
                ckpt.save(step + 1, *full)
            del full
            say(f"checkpointed step {step + 1}")
    say(f"done: {args.steps - start} steps in {time.time() - t0:.1f}s; "
        f"ledger last step = {plane.last_step(job)}")


if __name__ == "__main__":
    main()
