"""Qwen1.5-4B [hf:Qwen/Qwen1.5; hf] — 40L d=2560 20H (GQA kv=20 = MHA)
d_ff=6912 vocab=151936. QKV bias. 20 heads don't divide the 16-way model
axis -> attention runs data-parallel (see DESIGN.md hardware notes)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1_5_4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20,
    d_ff=6912, vocab_size=151936,
    qkv_bias=True, rope_theta=1_000_000.0,
    mlp_type="swiglu", norm="rmsnorm",
)


def smoke_config() -> ModelConfig:
    return CONFIG.derive(n_layers=2, d_model=60, n_heads=5, n_kv_heads=5,
                         d_ff=128, vocab_size=256)
