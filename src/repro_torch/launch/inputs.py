"""Abstract model inputs for every (arch x shape) cell, the JAX package's
``repro.launch.inputs``: each ``jax.ShapeDtypeStruct`` there is a tensor on
the ``meta`` device here (shape and dtype, no memory), as
``models.params.abstract_params`` gives for the parameters.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..configs import SHAPES
from ..models import init_cache_specs
from ..models.config import ModelConfig
from ..models.params import axes_tree
from ..parallel.sharding import MeshPolicy


def sds(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


#: cache leaves stored in bf16: KV caches + activation carries (conv
#: window, token-shift). The accumulating recurrent states (SSD `h`,
#: WKV `wkv`) stay f32.
_BF16_CACHE_KEYS = {"k", "v", "shared_k", "shared_v", "enc_out",
                    "conv", "shift_a", "shift_f"}


def batch_specs(cfg: ModelConfig, shape_name: str) -> Dict[str, Any]:
    """Model-input meta tensors for one shape cell."""
    sh = SHAPES[shape_name]
    B, S, kind = sh["batch"], sh["seq"], sh["kind"]
    if kind == "train":
        batch: Dict[str, Any] = {
            "tokens": sds((B, S), torch.int32),
            "labels": sds((B, S), torch.int32),
        }
    elif kind == "prefill":
        batch = {"tokens": sds((B, S), torch.int32)}
    else:  # decode: one new token; the CACHE holds the seq_len context
        batch = {"tokens": sds((B, 1), torch.int32)}
    # modality frontends are stubs: precomputed embeddings
    if cfg.family == "vlm" and kind in ("train", "prefill"):
        batch["patch_embeds"] = sds((B, cfg.n_patches, cfg.d_model),
                                    torch.bfloat16)
        batch["positions"] = sds((B, S, 3), torch.int32)
    if cfg.family == "encdec" and kind in ("train", "prefill"):
        batch["frames"] = sds((B, cfg.n_patches, cfg.d_model),
                              torch.bfloat16)
    return batch


def batch_axes(cfg: ModelConfig, shape_name: str) -> Dict[str, Any]:
    sh = SHAPES[shape_name]
    kind = sh["kind"]
    axes: Dict[str, Any] = {"tokens": ("batch", None)}
    if kind == "train":
        axes["labels"] = ("batch", None)
    if cfg.family == "vlm" and kind in ("train", "prefill"):
        axes["patch_embeds"] = ("batch", None, "act_embed")
        axes["positions"] = ("batch", None, None)
    if cfg.family == "encdec" and kind in ("train", "prefill"):
        axes["frames"] = ("batch", None, "act_embed")
    return axes


def cache_abstract(cfg: ModelConfig, shape_name: str,
                   kv_len: Optional[int] = None) -> Tuple[Any, Any]:
    """(abstract cache tree, cache logical-axes tree) for decode cells.
    `kv_len` overrides the cache length (ring_kv variant: window-bounded
    caches for uniform sliding-window archs)."""
    sh = SHAPES[shape_name]
    specs = init_cache_specs(cfg, sh["batch"], kv_len or sh["seq"])
    # kv caches are bf16; recurrent states (SSD h, WKV S, conv/shift
    # carries) stay f32 (they accumulate across the whole sequence)
    abstract = {k: sds(s.shape, torch.bfloat16 if k in _BF16_CACHE_KEYS
                       else torch.float32)
                for k, s in specs.items()}
    return abstract, axes_tree(specs)


def cell_policy(cfg: ModelConfig, shape_name: str, *,
                model_axis: int = 16, data_axis: int = 16,
                n_pods: int = 1, fsdp: bool = True) -> MeshPolicy:
    """Sharding policy for one (arch x shape) cell, handling divisibility
    fallbacks:
      - heads/kv_heads replicated when not divisible by the model axis;
      - batch replicated when smaller than the dp axis (long_500k B=1),
        with the KV cache sequence-sharded over `data` instead.
    """
    sh = SHAPES[shape_name]
    rules = {}
    dp = data_axis * n_pods
    if cfg.n_heads % model_axis:
        rules["heads"] = None
    if cfg.n_kv_heads % model_axis:
        rules["kv_heads"] = None
    if (cfg.d_model // cfg.rwkv_head_dim) and cfg.family == "ssm" and \
            cfg.d_model % model_axis:
        rules["heads_flat"] = None
    if cfg.vocab_size % model_axis:
        rules["vocab"] = None
    if cfg.d_ff % model_axis:
        rules["mlp"] = None
    if cfg.n_experts and cfg.n_experts % model_axis:
        # mixtral: 8 experts on a 16-way axis -> TP strategy (every rank
        # holds all experts, each expert's hidden dim sharded; see moe.py)
        rules["experts"] = None
        if (cfg.moe_d_ff or cfg.d_ff) % model_axis == 0:
            rules["expert_mlp"] = "model"
    seq_shard = False
    if sh["batch"] % dp:
        rules["batch"] = None
        seq_shard = True                    # long-context: shard KV seq
    use_fsdp = fsdp and cfg.d_model % data_axis == 0
    return MeshPolicy(fsdp=use_fsdp, seq_shard=seq_shard,
                      rules=tuple(rules.items()))
