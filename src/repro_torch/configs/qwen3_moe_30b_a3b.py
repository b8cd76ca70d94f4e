"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B] — 48L d=2048 32H (GQA kv=4)
expert d_ff=768, vocab=151936, MoE 128 experts top-8 (EP over `model`)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3_moe_30b_a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=6144, moe_d_ff=768, vocab_size=151936,
    n_experts=128, experts_per_token=8,
    rope_theta=1_000_000.0, mlp_type="swiglu", norm="rmsnorm",
)


def smoke_config() -> ModelConfig:
    return CONFIG.derive(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         d_ff=128, moe_d_ff=32, vocab_size=256,
                         n_experts=8, experts_per_token=2)
