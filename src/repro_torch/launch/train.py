"""End-to-end training driver, the JAX package's ``repro.launch.train``.

Wires together: config registry -> data pipeline (registry-backed shards)
-> train step -> checkpoint manager (manifests in the metadata plane)
-> fleet runtime (heartbeats, failover, elastic re-mesh).

Runs on the card unless ``--device cpu`` is given (without CUDA it
raises).  One card has no mesh: the step gets ``mesh=None`` and the fleet
a model axis of 1, what the reference's ``make_host_mesh()`` gives on one
device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1_5_4b \\
      --smoke --steps 20 --batch 8 --seq 64

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

from ..ckpt import CheckpointManager
from ..configs import ARCHS, get_config, get_smoke_config
from ..data import DataPipeline, synthetic_batch
from ..device import resolve_device
from ..metaplane import MetadataPlane
from ..models import init_params, param_specs
from ..parallel.sharding import MeshPolicy
from ..runtime import FleetRuntime
from ..train.optimizer import OptConfig, adamw_init
from ..train.step import make_train_step


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

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    policy = MeshPolicy()
    job = f"{args.arch}-train"

    plane = MetadataPlane(device=dev)
    fleet = FleetRuntime(plane, n_workers=4, model_axis=1)
    pipeline = DataPipeline(plane, f"{args.arch}-ds", n_shards=16)
    ckpt = CheckpointManager(args.ckpt_dir, plane, job, keep=2, device=dev)

    params = init_params(param_specs(cfg),
                         torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    opt_state = adamw_init(params)
    start = 0
    if args.resume:
        ckpt.register_committed()
        restored = ckpt.restore_latest()
        if restored is not None:
            start, params, opt_state = restored
            print(f"resumed from step {start}")

    opt = OptConfig(total_steps=max(args.steps, 1))
    step_fn = make_train_step(cfg, policy, None, opt=opt,
                              microbatches=args.microbatches, device=dev)

    t0 = time.time()
    for step in range(start, args.steps):
        fleet.tick()
        plane.tick()
        if step == args.fail_worker_at:
            fleet.fail_worker(0)
            print(f"[step {step}] injected worker-0 failure; "
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
            print(f"step {step:4d} loss {float(loss):8.4f} "
                  f"({time.time() - t0:5.1f}s)")
        if (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, params, opt_state)
            print(f"checkpointed step {step + 1}")
    print(f"done: {args.steps - start} steps in {time.time() - t0:.1f}s; "
          f"ledger last step = {plane.last_step(job)}")


if __name__ == "__main__":
    main()
