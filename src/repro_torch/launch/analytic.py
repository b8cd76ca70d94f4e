"""Analytic per-device HBM-traffic model (the "kernelized" memory term),
the JAX package's ``repro.launch.analytic``, plain Python as there.

It counts the device-memory bytes a kernelized execution moves — weights,
activations entering/leaving fused blocks, KV caches, optimizer state — per
device, per step, from the configuration, the shape cell, the policy and
the mesh's shape alone: the fused kernels (attention, SSD, WKV, the MoE
expert matmuls) keep their intermediates out of device memory and are
charged only their inputs and outputs.  The numbers are the reference's
formulas for any device; no rate or time is attached here.

Conventions (documented in EXPERIMENTS.md §Methodology):
  * bf16 activations/weights on the compute path; f32 optimizer state;
  * train ≈ fwd traffic + 2x for bwd (read saved activations + write
    grads) + optimizer pass (3 reads + 2 writes of f32 per param on the
    local shard);
  * fused kernels (attention / SSD / WKV / MoE expert matmuls) charge only
    kernel inputs + outputs;
  * remat policies re-read layer inputs (selective ~ +1 activation pass).
"""
from __future__ import annotations

from typing import Dict

from ..configs import SHAPES
from ..models.config import ModelConfig
from ..parallel.sharding import MeshPolicy

BF16 = 2
F32 = 4


def _shards(policy: MeshPolicy, mesh_shape: Dict[str, int]):
    rules = policy.resolve()

    def size_of(logical: str) -> int:
        m = rules.get(logical)
        if m is None:
            return 1
        axes = m if isinstance(m, (tuple, list)) else (m,)
        n = 1
        for a in axes:
            n *= mesh_shape.get(a, 1)
        return n
    return size_of


def layer_param_count(cfg: ModelConfig) -> float:
    """Parameters of ONE decoder layer (all experts for MoE)."""
    d, hd, nh, nkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    attn = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
    if cfg.family == "ssm":
        attn = 4 * d * d + d * 64 + 64 * d
    if cfg.family == "hybrid":
        d_in = cfg.ssm_expand * d
        attn = d * (2 * d_in + 2 * cfg.ssm_state) + d_in * d
    f = cfg.moe_d_ff if cfg.is_moe else cfg.d_ff
    per_expert = (3 if cfg.mlp_type == "swiglu" else 2) * d * f
    mlp = (cfg.n_experts or 1) * per_expert
    return attn + mlp + 4 * d


def active_layer_param_count(cfg: ModelConfig) -> float:
    if not cfg.is_moe:
        return layer_param_count(cfg)
    full = layer_param_count(cfg)
    f = cfg.moe_d_ff or cfg.d_ff
    per_expert = (3 if cfg.mlp_type == "swiglu" else 2) * cfg.d_model * f
    return full - (cfg.n_experts - cfg.experts_per_token) * per_expert


def analytic_bytes(cfg: ModelConfig, shape_name: str, policy: MeshPolicy,
                   mesh_shape: Dict[str, int]) -> Dict[str, float]:
    """Per-device HBM bytes for one step, assuming kernelized inner loops."""
    sh = SHAPES[shape_name]
    B, S, kind = sh["batch"], sh["seq"], sh["kind"]
    size_of = _shards(policy, mesh_shape)
    dp = size_of("batch")
    tp_mlp = size_of("mlp")
    tp_heads = size_of("heads")
    tp_vocab = size_of("vocab")
    fsdp = size_of("embed")
    n_chips = 1
    for v in mesh_shape.values():
        n_chips *= v

    d = cfg.d_model
    L = cfg.n_layers if cfg.family != "encdec" \
        else cfg.n_enc_layers + cfg.n_dec_layers
    tokens_dev = B * (S if kind != "decode" else 1) / dp

    # ---- weights traffic: each layer's local weight shard read once ----
    lp = layer_param_count(cfg)
    # MoE EP/TP shards experts; dense shards mlp/heads; fsdp shards the rest
    w_shard = max(tp_mlp, tp_heads if cfg.family not in ("ssm",) else 1,
                  size_of("experts"))
    w_dev = L * lp / max(w_shard, fsdp) + \
        2 * cfg.vocab_size * d / max(tp_vocab * fsdp, 1)
    weight_bytes = w_dev * BF16

    # ---- activation traffic: ~8 fused-block boundaries per layer --------
    act_pass = tokens_dev * d * BF16
    act_bytes = L * 8 * act_pass

    # ---- attention kernel IO -------------------------------------------
    hd, nh, nkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    qkv_dev = tokens_dev * (nh + 2 * nkv) / tp_heads * hd * BF16
    attn_io = L * (qkv_dev * 2 + 2 * tokens_dev * nh / tp_heads * hd * BF16)
    if kind == "decode":
        # decode reads the whole KV cache (window-limited for local layers)
        kv_shard = size_of("kv_heads") * size_of("kv_seq")
        n_global = L
        if cfg.global_interval:
            n_global = L // cfg.global_interval
            n_local = L - n_global
        else:
            n_local = 0
        if cfg.sliding_window and not cfg.global_interval:
            n_global, n_local = 0, L
        eff_S_global, eff_S_local = S, min(S, cfg.sliding_window or S)
        if cfg.family == "ssm":
            attn_io = L * (B / dp) * (d // cfg.rwkv_head_dim) * \
                cfg.rwkv_head_dim ** 2 * F32 * 2
        elif cfg.family == "hybrid":
            d_in = cfg.ssm_expand * d
            H = cfg.ssm_heads or d_in // 64
            state = (B / dp) * H * (d_in // H) * cfg.ssm_state * F32 * 2
            n_apps = max(1, L // max(1, cfg.shared_attn_every))
            kv = n_apps * (B / dp) * S * nkv * hd / kv_shard * BF16 * 2
            attn_io = L * state + kv
        else:
            attn_io = (n_global * eff_S_global + n_local * eff_S_local) * \
                (B / dp) * nkv * hd / kv_shard * BF16 * 2

    # ---- logits ----------------------------------------------------------
    logit_bytes = tokens_dev * cfg.vocab_size / tp_vocab * BF16 * 2

    fwd = weight_bytes + act_bytes + attn_io + logit_bytes
    if kind == "train":
        n_params_dev = (L * lp + 2 * cfg.vocab_size * d) / \
            max(n_chips // dp * dp, 1)  # opt state is fully sharded
        n_params_dev = (L * lp + 2 * cfg.vocab_size * d) / n_chips
        opt_bytes = n_params_dev * (3 * F32 + 2 * F32)
        total = 3.0 * fwd + opt_bytes
    else:
        total = fwd
    return {"weight_bytes": weight_bytes, "act_bytes": act_bytes,
            "attn_io": attn_io, "logit_bytes": logit_bytes,
            "total": total}


def analytic_collective_bytes(cfg: ModelConfig, shape_name: str,
                              policy: MeshPolicy,
                              mesh_shape: Dict[str, int]
                              ) -> Dict[str, float]:
    """Expected per-device collective bytes with a tuned partitioner.

    The schedule each strategy's collectives follow (the reference's
    model of them):

      FSDP   : 2x param all-gather (fwd+bwd) + grad reduce-scatter
      TP     : 2 activation psums/layer fwd, 2 bwd (attention out, FFN out)
      EP     : 2 all-to-alls fwd + 2 bwd of the dispatched token buffers
      logits : bwd dx all-reduce over the vocab axis
      DP/pod : folded into the grad reduce-scatter bytes (DCN for pods)
    """
    sh = SHAPES[shape_name]
    B, S, kind = sh["batch"], sh["seq"], sh["kind"]
    size_of = _shards(policy, mesh_shape)
    dp = size_of("batch")
    fsdp = size_of("embed")
    tp = max(size_of("mlp"), size_of("heads"), size_of("experts"), 1)
    d = cfg.d_model
    L = cfg.n_layers if cfg.family != "encdec" \
        else cfg.n_enc_layers + cfg.n_dec_layers
    tokens_dev = B * (S if kind != "decode" else 1) / dp
    lp = layer_param_count(cfg)
    total_params = L * lp + 2 * cfg.vocab_size * d

    out: Dict[str, float] = {}
    # FSDP param movement (bf16), ring factor (n-1)/n ~ 1
    if fsdp > 1:
        n_ag = 2 if kind == "train" else 1
        out["fsdp_allgather"] = n_ag * total_params / max(tp, 1) * BF16
    # gradient reduce-scatter (+ cross-pod all-reduce folded in); bf16 when
    # gradient compression is on
    if kind == "train":
        gbytes = BF16 if cfg.grad_compress else F32
        out["grad_reduce"] = total_params / max(tp, 1) * gbytes
    # TP activation psums. Dense: 2/layer fwd (attention out + FFN out);
    # EP-MoE: 1/layer (expert combine travels in the all-to-all term).
    # Train doubles them (Megatron: 2 fwd + 2 bwd ARs per layer).
    if tp > 1:
        per_layer = 1 if (cfg.is_moe and size_of("experts") > 1) else 2
        n_psum = per_layer * L * (2 if kind == "train" else 1)
        # ring all-reduce moves ~2x payload
        out["tp_psum"] = n_psum * tokens_dev * d * BF16 * 2
    # MoE all-to-all (2/layer fwd, 2 bwd)
    if cfg.is_moe and size_of("experts") > 1:
        n_a2a = 2 * L * (2 if kind == "train" else 1)
        out["moe_a2a"] = n_a2a * tokens_dev * d * BF16 * \
            cfg.experts_per_token * cfg.capacity_factor / \
            max(cfg.experts_per_token, 1)
    # lm-head bwd dx all-reduce
    if kind == "train" and size_of("vocab") > 1:
        out["logit_bwd"] = tokens_dev * d * F32 * 2
    out["total"] = sum(v for k, v in out.items())
    return out
