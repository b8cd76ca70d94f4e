"""Zamba2-2.7B [arXiv:2411.15242; hf] — 54L d=2560, Mamba2 backbone
(state=64) + SHARED attention block (32H, kv=32) every 6 layers,
d_ff=10240 vocab=32000."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2_2_7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_heads=80, ssm_expand=2, ssm_conv=4,
    shared_attn_every=6,
    mlp_type="swiglu", norm="rmsnorm", rope_theta=10_000.0,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.derive(n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
                         d_ff=128, vocab_size=256, ssm_state=16,
                         ssm_heads=4, shared_attn_every=2)
