"""Qwen2-VL-7B [arXiv:2409.12191; hf] — 28L d=3584 28H (GQA kv=4)
d_ff=18944 vocab=152064. M-RoPE over (t,h,w); dynamic-resolution vision
frontend is a STUB (precomputed patch embeddings via input_specs)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2_vl_7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab_size=152064,
    rope_theta=1_000_000.0, mrope=True, mrope_sections=(16, 24, 24),
    qkv_bias=True, mlp_type="swiglu", norm="rmsnorm",
    n_patches=1024,
)


def smoke_config() -> ModelConfig:
    return CONFIG.derive(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         d_ff=128, vocab_size=256, n_patches=8,
                         mrope_sections=(4, 2, 2))
