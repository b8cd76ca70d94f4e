"""qwen1.5-4B at 4 layers in fp32 on a (2, 2) mesh of four cards against
one card: the forward's summed NLL under each policy (tensor parallelism,
FSDP, both, data parallelism alone), with and without remat and the
kernels, and its relative difference from one card's on the whole
batch.

  python3 scripts/tp_rounding.py
"""
import json
import sys
from pathlib import Path
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import torch  # noqa: E402
import chip_smoke as C  # noqa: E402


def rank_fn(rank, world, dev, seed):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, param_specs, shard_params
    from repro_torch.models.lm import nll_terms
    from repro_torch.parallel.sharding import MeshPolicy, storage_pspecs
    mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "model"))
    out = {"tf32": [torch.backends.cuda.matmul.allow_tf32,
                    torch.get_float32_matmul_precision()]}
    base = get_config("qwen1_5_4b").derive(n_layers=4, dtype="float32")
    whole = (("heads", None), ("kv_heads", None), ("mlp", None),
             ("vocab", None))
    policies = {"tp": MeshPolicy(), "fsdp": MeshPolicy(fsdp=True,
                                                       rules=whole),
                "tp_fsdp": MeshPolicy(fsdp=True),
                "dp": MeshPolicy(rules=whole)}
    full = init_params(param_specs(base), torch.Generator(
        device=dev).manual_seed(seed + 24), device=dev)
    batch = C._lm_batch(base, 2, 256, seed + 24)
    for remat in ("none", "full"):
        cfg = base.derive(remat=remat)
        for uk in (True, False):
            if rank == 0:
                with torch.no_grad():
                    t, n = nll_terms(full, batch, cfg=cfg, use_kernels=uk,
                                     device=dev)
                out[f"one/{remat}/{uk}"] = float(t)
            for name, pol in policies.items():
                p = shard_params(full, storage_pspecs(param_specs(cfg), pol,
                                                      mesh), mesh, dev)
                rows = C._rows(batch, pol, mesh, dev)
                with torch.no_grad():
                    t, n = nll_terms(p, rows, cfg=cfg, policy=pol, mesh=mesh,
                                     use_kernels=uk, device=dev)
                dist.all_reduce(t, group=mesh.get_group("data"))
                out[f"{name}/{remat}/{uk}"] = float(t)
                del p
    dist.barrier()
    return out


if __name__ == "__main__":
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import spawn_ranks
    import tempfile
    _build.library()
    with tempfile.TemporaryDirectory() as d:
        res = spawn_ranks(rank_fn, 4, 0, store_dir=d, device_type="cuda",
                          timeout=400)
    r0 = res[0]
    print(json.dumps(r0, indent=1), flush=True)
    for k, v in r0.items():
        if isinstance(v, float):
            remat, uk = k.split("/")[1:]
            one = r0[f"one/{remat}/{uk}"]
            print(f"{k:24s} {v:.6f} rel {v / one - 1:+.3e}", flush=True)
