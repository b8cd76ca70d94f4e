"""gemma3 at full width in fp32 with a bf16 cache of 65,536 random rows,
its sequence split over a (4, 1) mesh of four cards (chip_smoke.py's
``seq_rank`` inputs), against one card's whole cache: for 1, 2 and 12
layers, each decode step's largest logit distance and, per layer, the
largest distance of the rows the steps wrote (how a rounding of the
combined softmax grows with depth in the random weights).

  python3 scripts/seq_rounding.py
"""
import json
import sys
import tempfile
from pathlib import Path
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import torch  # noqa: E402
import chip_smoke as C  # noqa: E402

DEPTHS = (1, 2, 12)


def rank_fn(rank, world, dev, seed):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, param_specs
    from repro_torch.parallel.sharding import all_gather_list, seq_part
    mesh = init_device_mesh("cuda", (world, 1),
                            mesh_dim_names=("data", "model"))
    policy = C.seq_policy()
    group = seq_part(policy, mesh)[0]
    out = {"tf32": [torch.backends.cuda.matmul.allow_tf32,
                    torch.get_float32_matmul_precision()]}
    rows = C.SEQ_S // world
    for L in DEPTHS:
        cfg = get_config("gemma3_12b").derive(n_layers=L, dtype="float32")
        params = init_params(param_specs(cfg), torch.Generator(
            device=dev).manual_seed(seed + 26), device=dev)
        whole = C.seq_cache(cfg, C.SEQ_S, seed + 27, dev)
        cache = {k: v[:, :, rank * rows:(rank + 1) * rows].clone()
                 for k, v in whole.items()}
        logits, cache = C.seq_steps(params, cache, cfg, policy, mesh, dev,
                                    C.SEQ_STEPS, seed + 28)
        got = {k: torch.cat(all_gather_list(v, group), 2)
               for k, v in cache.items()}
        if rank == 0:
            one, ref = C.seq_steps(params, whole, cfg, policy, None, dev,
                                   C.SEQ_STEPS, seed + 28)
            out[f"layers_{L}"] = {
                "logits_max_abs": [float((a - b).abs().max())
                                   for a, b in zip(logits, one)],
                "one_card_logits_max_abs": [float(b.abs().max())
                                            for b in one],
                "written_rows_max_abs": {k: [[float(
                    (got[k][i, :, s].float() - ref[k][i, :, s].float())
                    .abs().max()) for s in C.SEQ_STEPS] for i in range(L)]
                    for k in got}}
            del ref
        del params, whole, cache, got
        torch.cuda.empty_cache()
        dist.barrier()
    return out


if __name__ == "__main__":
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import spawn_ranks
    _build.library()
    with tempfile.TemporaryDirectory() as d:
        res = spawn_ranks(rank_fn, 4, 0, store_dir=d, device_type="cuda",
                          timeout=500)
    print(json.dumps(res[0]))
