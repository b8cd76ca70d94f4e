"""Mixtral-8x22B [arXiv:2401.04088; hf] — 56L d=6144 48H (GQA kv=8)
expert d_ff=16384, vocab=32768, MoE 8 experts top-2, sliding-window attn.
8 experts don't divide the 16-way model axis -> TP expert strategy."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral_8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, moe_d_ff=16384, vocab_size=32768,
    n_experts=8, experts_per_token=2,
    sliding_window=4096,
    rope_theta=1_000_000.0, mlp_type="swiglu", norm="rmsnorm",
)


def smoke_config() -> ModelConfig:
    return CONFIG.derive(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         d_ff=128, moe_d_ff=128, vocab_size=256,
                         n_experts=4, experts_per_token=2,
                         sliding_window=16)
