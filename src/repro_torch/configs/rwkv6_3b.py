"""RWKV-6 "Finch" 3B [arXiv:2404.05892; hf] — 32L d=2560 (attention-free)
d_ff=8960 vocab=65536. Data-dependent decay; constant-state decode."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6_3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,  # 40*64 = 2560
    d_ff=8960, vocab_size=65536,
    rwkv_head_dim=64,
    mlp_type="relu2", norm="layernorm",
)


def smoke_config() -> ModelConfig:
    return CONFIG.derive(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                         d_ff=128, vocab_size=256, rwkv_head_dim=16)
