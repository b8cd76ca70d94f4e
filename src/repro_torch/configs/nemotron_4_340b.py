"""Nemotron-4-340B [arXiv:2402.16819; unverified] — 96L d=18432 96H (GQA
kv=8) d_ff=73728 vocab=256000. Squared-ReLU MLP."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron_4_340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8,
    d_ff=73728, vocab_size=256000,
    mlp_type="relu2", norm="layernorm", rope_theta=10_000.0,
)


def smoke_config() -> ModelConfig:
    return CONFIG.derive(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         d_ff=128, vocab_size=256)
