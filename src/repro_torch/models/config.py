"""Model configuration covering all ten assigned architecture families."""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // n_heads

    # ---- attention ----
    rope_theta: float = 1e4
    mrope: bool = False                     # qwen2-vl M-RoPE (t,h,w sections)
    mrope_sections: Tuple[int, ...] = (16, 24, 24)   # per half-dim
    qkv_bias: bool = False                  # qwen1.5
    sliding_window: Optional[int] = None    # mixtral SWA / gemma3 local
    global_interval: Optional[int] = None   # gemma3: every Nth layer global
    parallel_block: bool = False            # command-r: attn+FFN in parallel
    logit_softcap: Optional[float] = None

    # ---- mlp ----
    mlp_type: str = "swiglu"                # swiglu | relu2 | gelu
    tie_embeddings: bool = False

    # ---- MoE ----
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: Optional[int] = None          # expert hidden dim
    capacity_factor: float = 1.25

    # ---- SSM / hybrid (zamba2, rwkv6) ----
    ssm_state: int = 0                      # mamba2 N
    ssm_heads: int = 0                      # mamba2 heads (d_inner/headdim)
    ssm_expand: int = 2
    ssm_conv: int = 4
    shared_attn_every: int = 0              # zamba2: shared block interval
    rwkv_head_dim: int = 64

    # ---- encoder-decoder (seamless) ----
    n_enc_layers: int = 0
    n_dec_layers: int = 0

    # ---- VLM (qwen2-vl) ----
    n_patches: int = 1024                   # precomputed patch embeddings

    # ---- norms / precision ----
    norm: str = "rmsnorm"                   # rmsnorm | layernorm
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    # ---- runtime knobs (hillclimbed in §Perf) ----
    remat: str = "none"               # none | full | selective
    scan_layers: bool = True
    # gradient compression: cast grads to bf16 before the cross-device
    # reduction (halves DP/FSDP gradient bytes; f32 accumulation resumes
    # inside the optimizer)
    grad_compress: bool = False
    # dry-run accounting: unroll inner (seq-chunk) scans so HLO cost
    # analysis sees every iteration (cost_analysis counts loop bodies once)
    unroll_scans: bool = False
    # flash-attention tile sizes (the Pallas kernel's block shape; also the
    # jnp blocked-attention tiling). Cost compiles raise these for long
    # sequences to bound HLO size.
    attn_block_q: int = 512
    attn_block_k: int = 512

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None \
            else self.d_model // self.n_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def derive(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    # ------------------------------------------------------------------
    # parameter count (dense formulas; MoE counts all + active separately)
    # ------------------------------------------------------------------
    def param_count(self) -> int:
        d, L = self.d_model, self.n_layers
        hd, nh, nkv = self.hd, self.n_heads, self.n_kv_heads
        attn = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
        if self.family == "ssm":                      # rwkv6: no attention
            attn = 4 * d * d + d * d // 2             # r,k,v,o + decay lora
        mlp_in = self.moe_d_ff if self.is_moe else self.d_ff
        per_expert = (3 if self.mlp_type == "swiglu" else 2) * d * mlp_in
        if self.is_moe:
            mlp = self.n_experts * per_expert + d * self.n_experts
        else:
            mlp = (3 if self.mlp_type == "swiglu" else 2) * d * self.d_ff
        dense_mlp = 0
        if self.family == "hybrid":
            # mamba2 mixer instead of attention
            d_in = self.ssm_expand * d
            attn = d * (2 * d_in + 2 * self.ssm_state) + d_in * d
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        layers = L if self.family != "encdec" \
            else (self.n_enc_layers + self.n_dec_layers)
        return layers * (attn + mlp + dense_mlp + 4 * d) + emb

    def active_param_count(self) -> int:
        """Per-token active params (MoE: only top-k experts)."""
        if not self.is_moe:
            return self.param_count()
        full = self.param_count()
        per_expert = (3 if self.mlp_type == "swiglu" else 2) * \
            self.d_model * (self.moe_d_ff or self.d_ff)
        inactive = (self.n_experts - self.experts_per_token) * per_expert
        return full - self.n_layers * inactive
