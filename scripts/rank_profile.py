"""Phase 17's qwen3-moe rank steps (decode_32k, prefill_32k) on the card,
timed and profiled by ``torch.profiler``: the warm call with its
collectives' outputs filled (``StepRecorder(fill=True, track=False)``),
without, and filled again; each call's wall and device time and its
operators by device time.

  python3 scripts/rank_profile.py
"""
import sys
from pathlib import Path
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import torch  # noqa: E402
import chip_smoke as C  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

if __name__ == "__main__":
    _build.library()
    dev = C.card()
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.inputs import cell_policy
    from torch.profiler import ProfilerActivity, profile
    for arch, shape in (("qwen3_moe_30b_a3b", "decode_32k"),
                        ("qwen3_moe_30b_a3b", "prefill_32k")):
        cfg = get_config(arch)
        with dryrun.fake_world(256):
            mesh = dryrun.make_production_mesh(device_type="cpu")
            policy = cell_policy(cfg, shape)
            args = dryrun.rank_inputs(cfg, shape, mesh, policy, device=dev,
                                      seed=0)
            cache = args.get("cache")

            def step():
                args["cache"] = cache
                return dryrun.rank_step(cfg, shape, args, mesh=mesh,
                                        policy=policy, device=dev)

            with dryrun.StepRecorder(fill=True):
                out = step()
            del out
            for tag, rec in (("filled", True), ("unrecorded", False),
                             ("filled", True)):
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    if rec:
                        with dryrun.StepRecorder(fill=True, track=False):
                            out, t = C.timed(step)
                    else:
                        out, t = C.timed(step)
                del out
                ka = prof.key_averages()
                cuda = sum(e.self_device_time_total for e in ka) / 1e6
                print(f"{arch} {shape} {tag}: wall {t:.4f} s, device "
                      f"{cuda:.4f} s", flush=True)
                print(ka.table(sort_by="self_device_time_total",
                               row_limit=12, max_name_column_width=50),
                      flush=True)
            del args, cache
            torch.cuda.empty_cache()
