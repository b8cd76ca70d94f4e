"""Gemma3-12B [hf:google/gemma-3; unverified] — 48L d=3840 16H (GQA kv=8)
d_ff=15360 vocab=262144. 5 local (sliding 1024) : 1 global interleave,
128k context."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3_12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8,
    head_dim=256, d_ff=15360, vocab_size=262144,
    sliding_window=1024, global_interval=6,   # 5 local : 1 global
    rope_theta=1_000_000.0, mlp_type="gelu", norm="rmsnorm",
    tie_embeddings=True, logit_softcap=None,
)


def smoke_config() -> ModelConfig:
    return CONFIG.derive(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                         head_dim=16, d_ff=128, vocab_size=256,
                         sliding_window=16, global_interval=2)
