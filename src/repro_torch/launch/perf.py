"""§Perf hillclimb driver, the JAX package's ``repro.launch.perf``: re-run
ONE cell's dry run (``launch.dryrun.run_cell``) under a named variant and
diff its roofline terms against the baseline JSON.

  PYTHONPATH=src python -m repro_torch.launch.perf --arch gemma3_12b \\
      --shape decode_32k --variant serve_replicated

Variants (the §Perf iteration levers):
  serve_replicated — decode/prefill with fsdp=False: weights replicated
                     over `data`, sharded over `model` only. Kills the
                     per-step FSDP param all-gather that dominates decode.
  seq_parallel     — the KV caches' sequence over `data` (``kv_seq``;
                     activations' ``seq`` stays whole), where the batch
                     leaves `data` free: each rank holds its rows of the
                     cache and the decode combines the ranks' partial
                     softmaxes (``models.layers.attention_block``), as
                     the long_500k cells' ``seq_shard`` does.
  ring_kv          — window-bounded KV cache for uniform-sliding-window
                     archs (mixtral): cache length = window, not seq_len.
  microbatch4      — gradient accumulation over 4 microbatches (activation
                     memory lever for train cells).
  remat_full       — full activation rematerialization (memory vs FLOPs).
  unroll_layers    — scan_layers=False (latency vs compile-size lever).
                     The port runs its layers in a Python loop whatever
                     ``cfg.scan_layers`` says (``models/lm.py``), so this
                     variant's deltas are zero by construction.

The baseline is ``launch.dryrun``'s file of the cell under
``results/dryrun_torch/``; the variant's lands beside it.  The roofline's
constants are the H100's (``launch.dryrun``).
"""
import argparse
import json
from typing import Any, Dict, Optional, Tuple

from ..configs import ARCHS, SHAPES, get_config
from ..models.config import ModelConfig
from ..parallel.sharding import MeshPolicy
from .dryrun import RESULTS, cell_path, run_cell
from .inputs import cell_policy

VARIANTS = ("serve_replicated", "seq_parallel", "ring_kv", "microbatch4",
            "remat_full", "unroll_layers", "grad_compress", "capacity_1x",
            "serve_replicated_ring", "baseline")


def variant_overrides(variant: str, cfg: ModelConfig, shape: str
                      ) -> Tuple[ModelConfig, Optional[MeshPolicy],
                                 Dict[str, Any]]:
    """Returns (cfg', policy' or None to use default, run_cell kwargs)."""
    kind = SHAPES[shape]["kind"]
    if variant == "serve_replicated":
        assert kind in ("decode", "prefill"), "serving-only variant"
        pol = cell_policy(cfg, shape, fsdp=False)
        return cfg, pol, {}
    if variant == "seq_parallel":
        pol = cell_policy(cfg, shape).with_rules(kv_seq="data", seq=None)
        return cfg, pol, {}
    if variant == "ring_kv":
        assert cfg.sliding_window and not cfg.global_interval, \
            "uniform-SWA archs only"
        return cfg, None, {"kv_len_override": cfg.sliding_window}
    if variant == "serve_replicated_ring":
        assert cfg.sliding_window and kind == "decode"
        pol = cell_policy(cfg, shape, fsdp=False)
        return cfg, pol, {"kv_len_override": cfg.sliding_window}
    if variant == "microbatch4":
        assert kind == "train"
        return cfg, None, {"microbatches": 4}
    if variant == "remat_full":
        return cfg.derive(remat="full"), None, {}
    if variant == "grad_compress":
        assert kind == "train"
        return cfg.derive(grad_compress=True), None, {}
    if variant == "capacity_1x":
        assert cfg.is_moe
        return cfg.derive(capacity_factor=1.0), None, {}
    if variant == "unroll_layers":
        return cfg.derive(scan_layers=False), None, {}
    return cfg, None, {}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--shape", choices=list(SHAPES), required=True)
    ap.add_argument("--variant", choices=VARIANTS, required=True)
    ap.add_argument("--multipod", action="store_true")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    cfg2, pol, kw = variant_overrides(args.variant, cfg, args.shape)
    res = run_cell(args.arch, args.shape, multi_pod=args.multipod,
                   cfg_override=cfg2, policy_override=pol, **kw)
    RESULTS.mkdir(parents=True, exist_ok=True)
    out = RESULTS / (f"{args.arch}__{args.shape}__"
                     f"{'2x16x16' if args.multipod else '16x16'}"
                     f"__{args.variant}.json")
    out.write_text(json.dumps(res, indent=1))

    base_p = cell_path(args.arch, args.shape, args.multipod)
    if base_p.exists():
        base = json.loads(base_p.read_text())
        b, v = base["roofline"], res["roofline"]
        print(f"--- {args.arch} {args.shape} : baseline -> {args.variant}")
        for term in ("compute_s", "memory_s", "collective_s"):
            delta = (v[term] / b[term] - 1) * 100 if b[term] else 0.0
            print(f"{term:14s} {b[term]:10.4f} -> {v[term]:10.4f} "
                  f"({delta:+.1f}%)")
        print(f"dominant       {b['dominant']} -> {v['dominant']}   "
              f"bound {b['bound_s']:.4f}s -> {v['bound_s']:.4f}s "
              f"({(v['bound_s'] / b['bound_s'] - 1) * 100:+.1f}%)")
        bf = base["model_flops"]["roofline_fraction"]
        vf = res["model_flops"]["roofline_fraction"]
        print(f"roofline frac  {bf:.4f} -> {vf:.4f}")


if __name__ == "__main__":
    main()
