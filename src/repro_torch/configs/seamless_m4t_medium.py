"""SeamlessM4T-medium [arXiv:2308.11596; hf] — 12L enc + 12L dec, d=1024
16H (kv=16) d_ff=4096 vocab=256206 (padded to 256256 for 16-way TP).
Speech frontend is a STUB: input_specs provides precomputed frame
embeddings [B, T_frames, d]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless_m4t_medium", family="encdec",
    n_layers=24, n_enc_layers=12, n_dec_layers=12,
    d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=256256,   # 256206 padded to /128
    n_patches=1024,                 # frame count stand-in for enc input
    mlp_type="gelu", norm="layernorm", rope_theta=10_000.0,
)


def smoke_config() -> ModelConfig:
    return CONFIG.derive(n_layers=4, n_enc_layers=2, n_dec_layers=2,
                         d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                         vocab_size=256, n_patches=16)
