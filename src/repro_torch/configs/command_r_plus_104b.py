"""Command R+ 104B [hf:CohereForAI; unverified] — 64L d=12288 96H (GQA
kv=8) d_ff=33792 vocab=256000. No biases; parallel attention+FFN block."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="command_r_plus_104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8,
    d_ff=33792, vocab_size=256000,
    parallel_block=True, tie_embeddings=True,
    rope_theta=75_000_000.0, mlp_type="swiglu", norm="layernorm",
)


def smoke_config() -> ModelConfig:
    return CONFIG.derive(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         d_ff=128, vocab_size=256)
